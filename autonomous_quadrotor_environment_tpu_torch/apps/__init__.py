"""Command-line entry points of the port
(python -m autonomous_quadrotor_environment_tpu_torch.apps.<name>)."""

import importlib.util


def have_matplotlib() -> bool:
    """Whether matplotlib can be imported. The study apps draw their
    figures with it; a machine may lack it (the CUDA card's does), and they
    then write every other file and say so."""
    return importlib.util.find_spec("matplotlib") is not None
