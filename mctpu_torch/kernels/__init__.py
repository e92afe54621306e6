"""The port's kernels: CUDA sources in ``csrc/``, wrappers and plain versions
here (K1 vanilla, K2/K3 basket, K4 CVA)."""
