"""Command-line entry points of the port
(python -m autonomous_quadrotor_environment_tpu_torch.apps.<name>)."""
