"""Host seconds of the run's CUDA-graph captures, each up to a sync of the
card: the program's own counter (`utils/graphs.CAPTURES`), summed over
set-up, where every shape is warmed up. Reads `capture_s.hover` (the
step-loop graphs) and `capture_s.landing` (the interval graphs); None
without a trace or where the program keeps no such counter."""


def read(ctx):
    if ctx.trace is None:
        return None
    from autonomous_quadrotor_environment_tpu_torch.utils import graphs

    captures = getattr(graphs, "CAPTURES", None)
    return None if captures is None or not captures.count else captures.seconds
