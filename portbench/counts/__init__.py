"""The yardstick's arithmetic: the operations and bytes each configuration's
work needs, counted once from its shapes, and the card's published peaks.

A count is of the work the configuration's arithmetic needs, not of what a
kernel does to get it: no product is counted three times because a kernel
forms it from three TF32 products, and nothing a kernel recomputes is
counted again. The physics, the sensor models and the tanh are left out,
so each share computed from these counts stays a lower bound of the true
one. A frozen copy of the counts `chip_smoke.py` used, with that rule.
"""
