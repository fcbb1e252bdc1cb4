"""nas_3d_unet_tpu_torch — the PyTorch/CUDA port of nas_3d_unet_tpu.

Runs the flagship derived net over whole volumes on an NVIDIA H100 (Hopper,
sm_90a), held against the JAX package beside it.  Module names mirror the
JAX package's so each counterpart is easy to find:

    ops/      candidate ops; ops/pgemm.py: hand-written CUDA kernels
              (csrc/pgemm.cu) with their plain PyTorch twins
    models/   genotype, derived cells, derived net
    infer/    sliding-window whole-volume inference and the patient loop
    metrics/  BraTS label/region mapping and region Dice
    utils/    CUDA-event timing
    bridge.py flax parameter trees <-> state_dicts

Activations are NDHWC fp32 and parameters keep flax's names and shapes.
The package imports no JAX.
"""
