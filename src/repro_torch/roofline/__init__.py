"""repro_torch.roofline -- per-call cost features of the port's kernels
(``counts.py``; the JAX package's ``roofline/hlo.py::feature_vector``).
"""
