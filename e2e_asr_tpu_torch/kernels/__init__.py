"""Wrappers of the hand-written CUDA kernels (sources in ../csrc).

Each module holds the wrapper, a plain PyTorch version of the same function
(`*_reference`), and a launch counter per kernel (a module-level int:
`LAUNCHES`, or `CELLS_LAUNCHES` and `OUTPUT_LAUNCHES` in dec_step) that
the wrapper increments where it launches the kernel and nowhere else. A
wrapper takes the plain version only for tensors on the CPU; for CUDA
tensors it launches the kernel or raises.
"""
