"""The plain reference of each configuration: plain PyTorch and NumPy,
importing neither JAX, nor the JAX package, nor anything of the port.

- ``siglip.py``: SigLIP's image tower in fp32 with TF32 off (and, for
  the control, the same in simulated fp8).
"""
