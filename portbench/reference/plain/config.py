"""The configuration dataclasses and constants the port's hover slice, its
PPO trainer and the visual-landing eval read.

A copy of the matching part of `autonomous_quadrotor_environment_tpu/config.py`
(the port imports nothing of the JAX package); tests hold
``dataclasses.asdict`` of every config here equal on both sides so the
copies cannot drift.
"""

from __future__ import annotations

import dataclasses
import math


@dataclasses.dataclass(frozen=True)
class PhysicsConfig:
    """Quadrotor physical constants (reference quadrotor_env.py:30-67)."""

    mass: float = 1.03            # M  [kg]
    gravity: float = 9.82         # G  [m/s^2]
    rho: float = 1.2041           # air density [kg/m^3]
    c_d: float = 1.1              # drag coefficient
    k_f: float = 1.435e-5         # motor thrust constant  [N/(rad/s)^2]
    k_m: float = 2.4086e-7        # motor moment constant  [N*m/(rad/s)^2]
    i_r: float = 5e-5             # rotor inertia [kg*m^2]
    t2wr: float = 2.0             # thrust-to-weight ratio
    j_xx: float = 16.83e-3        # inertia diagonal [kg*m^2]
    j_yy: float = 16.83e-3
    j_zz: float = 28.34e-3
    d_arm: float = 0.26           # motor distance to CG [m]
    beam_thickness: float = 0.05  # projected-area beam thickness [m]

    @property
    def area(self) -> tuple:
        """Projected areas (A_X, A_Y, A_Z)."""
        a_xy = self.beam_thickness * 2 * self.d_arm
        return (a_xy, a_xy, a_xy * 2)

    @property
    def max_motor_thrust(self) -> float:
        """Per-motor thrust ceiling T2WR*M*G/4."""
        return self.t2wr * self.mass * self.gravity / 4.0

    @property
    def hover_action_direct(self) -> float:
        """Neutral direct-mode action 2/T2WR - 1."""
        return 2.0 / self.t2wr - 1.0

    @property
    def arm_drag_sum(self) -> float:
        """sum(x_k^3) for x_k = linspace(0, D, 10), in closed form."""
        return self.d_arm**3 / 9.0**3 * sum(k**3 for k in range(10))


@dataclasses.dataclass(frozen=True)
class RandomizationConfig:
    """Magnitudes of per-episode physics perturbations and wind gusts
    (reference quadrotor_env.py:84-109 `robust_control`)."""

    enabled: bool = False
    d_kf: float = 0.1       # motor-constant degradation, U[0, d_kf) per motor
    d_m: float = 0.3        # mass factor, N(0, d_m)
    d_ir: float = 0.1       # rotor-inertia factor, U[0, d_ir) per motor
    d_j: float = 0.1        # inertia-diagonal factor, N(0, d_j) per axis
    gust_std: tuple = (5.0, 5.0, 2.0)  # wind gust std per axis [m/s]
    gust_period: int = 500  # integration steps between gust resamples
    # Per-episode severity: each reset draws s ~ U[0, 1] and scales every
    # magnitude (mid-episode gusts too, through DomainParams.gust_scale).
    # With `scaled` the stage severity becomes the upper bound.
    severity_sample: bool = False

    def scaled(self, severity: float) -> "RandomizationConfig":
        """Curriculum stage: every perturbation magnitude scaled by
        ``severity`` in [0, 1] (0 calm, 1 the reference's full
        robust_control); severity 0 turns randomization off."""
        return dataclasses.replace(
            self,
            enabled=self.enabled and severity > 0.0,
            d_kf=self.d_kf * severity,
            d_m=self.d_m * severity,
            d_ir=self.d_ir * severity,
            d_j=self.d_j * severity,
            gust_std=tuple(g * severity for g in self.gust_std),
        )


@dataclasses.dataclass(frozen=True)
class RewardConfig:
    """Shaped hover/position reward. Defaults = primary training env."""

    solved_reward: float = 20.0
    broken_reward: float = -20.0
    # shaping = -(c0*|vel|/BB_VEL + c1*|psi|/4 + c2*|roll,pitch|/BB_ANG)
    shaping_coefs: tuple = (3.75, 1.0, 0.25)
    p_c: float = 0.003            # absolute control penalty
    tr: tuple = (0.005, 0.01, 0.1)       # cascading steady-state thresholds
    tr_p: tuple = (3.0, 2.0, 1.0)        # cascading bonuses
    cascade_ang_all3: bool = False
    cascade_ang_factor: float = 4.0
    # Terminal rewards: added to the step reward (primary env) or replace it.
    terminal_replaces: bool = False

    @staticmethod
    def opt_variant() -> "RewardConfig":
        """The visual-landing worker's env reward (reference
        quadrotor_env_opt.py:62-69, :437-480): ~10x larger scale,
        replace-style terminal rewards."""
        return RewardConfig(
            solved_reward=500.0,
            broken_reward=-200.0,
            shaping_coefs=(100.0, 100.0, 30.0),
            p_c=1.0,
            tr=(0.001, 0.01, 0.1),
            tr_p=(300.0, 100.0, 10.0),
            cascade_ang_all3=True,
            cascade_ang_factor=2.0,
            terminal_replaces=True,
        )


BB_POS = 5.0
BB_VEL = 10.0
BB_ANG = math.pi / 2


@dataclasses.dataclass(frozen=True)
class EnvConfig:
    """Hover/position environment."""

    dt: float = 0.01              # integration time step [s]
    n_steps: int = 1000           # max env steps per episode (excl. warmup)
    warmup: int = 5               # initial zero-action steps
    hist_t: int = 5               # featurizer window length (obs = hist_t*15)
    direct_control: bool = True   # per-motor [-1,1] vs [F, Mx, My, Mz]
    clipped: bool = True          # motor clipping in indirect mode
    training: bool = True         # training mode: solve terminates episode
    rk_substeps: int = 1          # RK4 substeps per env step
    physics: PhysicsConfig = PhysicsConfig()
    reward: RewardConfig = RewardConfig()
    randomization: RandomizationConfig = RandomizationConfig()
    # Bounding box on [|vel|(3), |euler|(3), |ang_vel|(3)].
    bb_vel: float = BB_VEL
    bb_ang_rp: float = BB_ANG
    bb_ang_psi: float = 3.0 / 4.0 * math.pi
    bb_ang_vel: float = BB_VEL * 2
    bb_scale: float = 1.0
    effort_is_force: bool = False
    # Per-episode velocity target drawn U[-max, max] per axis; zeros = hover.
    vel_target_max: tuple = (0.0, 0.0, 0.0)

    @property
    def has_vel_target(self) -> bool:
        return any(m > 0.0 for m in self.vel_target_max)

    @property
    def max_steps(self) -> int:
        """Episode budget n + warmup."""
        return self.n_steps + self.warmup

    @staticmethod
    def landing_variant(training: bool = True) -> "EnvConfig":
        """The opt env as the visual-landing worker uses it (reference
        visual_landing/rl_worker.py:95: quad(0.01, 1500, 1, 5))."""
        return EnvConfig(
            dt=0.01,
            n_steps=1500,
            warmup=5,
            training=training,
            reward=RewardConfig.opt_variant(),
            bb_ang_psi=4.0,
            bb_ang_vel=BB_VEL * 3,
            bb_scale=1.0 if training else 1000.0,
            effort_is_force=True,
        )


@dataclasses.dataclass(frozen=True)
class SensorConfig:
    """Sensor noise and bias drift (reference quadrotor_env.py:587-591)."""

    accel_std: float = 0.1
    accel_bias_drift: float = 0.0005
    gyro_std: float = 0.035
    gyro_bias_drift: float = 0.00015
    magnet_std: float = 15.0
    magnet_bias_drift: float = 0.075
    gps_std_p: float = 1.71
    gps_std_v: float = 0.5
    enabled: bool = True          # reference `sensor.error` flag
    # Santo Andre magnetic vector in mG*0.01 (reference quadrotor_env.py:651-653)
    magnet_vec: tuple = (-40.47, 129.11, -98.99)


@dataclasses.dataclass(frozen=True)
class PPOConfig:
    """PPO hyperparameters (reference ppo.py:297-318). ``fused_compute="bf16"``
    runs the update kernels' products on bf16 operands with f32 sums, as the
    JAX package's kernels do. The reshuffle modes
    run in the landing trainer (`landing.ppo.landing_update`)."""

    lr: float = 5e-4
    gamma: float = 0.99
    gae_lambda: float = 0.99
    clip_eps: float = 0.2
    entropy_coef: float = 0.006
    value_coef: float = 0.5
    k_epochs: int = 10
    minibatch_size: int = 0       # 0 = full batch (reference state PPO)
    action_std: float = 0.1
    learn_std: bool = False       # FIXED_STD=True in reference ppo.py:301
    adam_b1: float = 0.9
    adam_b2: float = 0.999
    max_grad_norm: float = 0.0    # 0 = no clipping (reference has none)
    # Minibatches permute contiguous blocks of this many rows of the
    # flattened (T, B) batch (different envs at one timestep).
    shuffle_block: int = 128
    # The fused update kernels (ops/ppo_fused_t.py on the fully fused path,
    # ops/ppo_fused.py in the row-major ppo_update).
    fused_update: bool = False
    # Product operand type inside the fused update kernel ("f32" or "bf16").
    fused_compute: str = "f32"
    # The Adam step inside the row-major update kernel (kernel B4).
    fused_adam: bool = False
    reshuffle_per_update: bool = False
    reshuffle_per_epoch: bool = False

    @staticmethod
    def landing_variant() -> "PPOConfig":
        """Visual-landing PPO (reference ppo_trainer.py:28-38, :122)."""
        return PPOConfig(
            lr=2e-5,
            k_epochs=5,
            minibatch_size=1536,
            entropy_coef=0.01,
            learn_std=True,
            shuffle_block=1,
        )


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Rollout/training-loop shape for the state controller."""

    num_envs: int = 64            # parallel envs
    rollout_steps: int = 80       # steps per env per update
    network_size: int = 128       # hidden width N
    hist_t: int = 5               # featurizer window T
    updates: int = 2000
    eval_every: int = 5
    eval_episodes: int = 40
    seed: int = 0
    # Fresh-episode pool of the unfused rollout (0: a fresh reset per done).
    reset_pool: int = 0
    # The whole-rollout kernel (ops/rollout_fused.py) and the depth of its
    # fresh-episode pool for auto-reset.
    fused_rollout: bool = False
    fused_pool: int = 4


@dataclasses.dataclass(frozen=True)
class CameraConfig:
    """The landing camera (reference img_2_cv.py:13-14): a 36x24 mm film
    and 35 mm lens on an 84x84 buffer, so the pixels are anisotropic."""

    width: int = 84
    height: int = 84
    film_w: float = 36.0          # mm
    film_h: float = 24.0
    focal: float = 35.0           # mm

    @property
    def fx(self) -> float:
        """Focal length in pixels along x."""
        return self.focal / self.film_w * self.width

    @property
    def fy(self) -> float:
        return self.focal / self.film_h * self.height


@dataclasses.dataclass(frozen=True)
class MarkerConfig:
    """Checkerboard landing marker (reference ppo_world_setup.py:97-103,
    computer_vision/detector_setup.py:10-15)."""

    cols: int = 9                 # inner corners
    rows: int = 6
    scale: float = 0.5
    sqr_size: float = 0.2046

    @property
    def square(self) -> float:
        """World-space square side = scale * sqr_size."""
        return self.scale * self.sqr_size


@dataclasses.dataclass(frozen=True)
class LandingConfig:
    """Hierarchical visual-landing task (reference rl_worker.py:25-66)."""

    total_steps: int = 1500       # physics steps per episode
    task_interval: int = 10       # physics steps per policy decision
    velocity_scale: tuple = (0.5, 0.5, 1.0)
    velocity_d: tuple = (0.0, 0.0, -1.0 / 1.5)
    image_size: int = 84
    image_channels: int = 3
    ground_z: float = -5.0        # landing plane in env world coords
    marker_std: float = 0.8       # marker position N(0, 0.8) in xy
    eval_episodes: int = 100      # reference rl_eval_worker.py:43
