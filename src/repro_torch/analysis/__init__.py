"""The analysis layer: the H100 roofline (``roofline``). The JAX package's
``analysis/hlo.py`` parses XLA's optimized HLO text, which the port does
not have; its role (flops, HBM bytes and wire bytes per device of a step)
goes to ``roofline.step_cost``."""
