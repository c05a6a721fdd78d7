"""Hand-written Hopper kernels of the port, their plain PyTorch versions
(``ref``), and the device router (``ops``).  ``build`` compiles the CUDA
sources under ``csrc/`` at the first launch."""
