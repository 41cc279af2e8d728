"""Wrappers of the hand-written CUDA kernels (sources in ../csrc).

Each module holds the wrapper, a plain PyTorch version of the same function
(`*_reference`), and a launch counter per kernel entry (module-level ints
named `*LAUNCHES`) that the wrapper increments where it launches the
kernel and nowhere else. A wrapper takes the plain version only for
tensors on the CPU; for CUDA tensors it launches the kernel or raises.
Kernels with a gradient sit in a `torch.autograd.Function` whose backward
is the hand-written backward kernel (lstm_bidir, lstm_seq, dec_train).
"""
