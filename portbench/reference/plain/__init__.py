"""A frozen copy of the port's plain (kernel-free, graph-free) env modules.

The benchmark's reference steps its envs through these files, so that a
later change to the program cannot move the yardstick: the hover env and
its physics, sensors and rewards, the landing task, and the plain nadir
renderer. Two edits were made to the copy: `landing/env.py` renders with
the plain `render.scene.render_nadir` in place of the render kernel, and
runs each decision interval eagerly in place of a CUDA graph replay.
`checkpoint.py` keeps the msgpack reader only. Nothing here imports the
program.
"""
