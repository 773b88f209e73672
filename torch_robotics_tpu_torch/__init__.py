"""PyTorch / CUDA port of ``torch_robotics_tpu``.

The JAX package stays the reference; this package re-implements three of
its paths on PyTorch tensors (Panda GPMP2-MPC in EnvSpheres3D, batched
iLQR, and the UR10 + dual-Panda multi-robot MPC), with the TPU kernels of
those paths rewritten as hand-written CUDA kernels for Hopper
(``csrc/``).  Every constructor and entry point takes an explicit
``device`` that defaults to ``"cuda"``: without a GPU a default
construction raises, and the CPU runs only when the caller asks for it.

Importing the package starts no build and touches no device.
"""
