"""nas_3d_unet_tpu_torch — the PyTorch/CUDA port of nas_3d_unet_tpu.

Searches a cell with DARTS, trains the derived net and runs it over whole
volumes on an NVIDIA H100 (Hopper, sm_90a), held against the JAX package
beside it.  Module
names mirror the JAX package's so each counterpart is easy to find:

    ops/      candidate ops (pools and upsample: ops/pool.py) and
              GroupNorm; ops/pgemm.py and ops/stats.py:
              hand-written CUDA kernels (csrc/) with their plain PyTorch
              twins, ops/_cuda.py: their launch count and checks
    models/   α and genotype, supernet and derived cells, SuperNet and
              DerivedNet (fp32 or bf16), activation checkpointing
    parallel/ data parallelism over torch.distributed (torchrun)
    search/   the bilevel search step, warmup step and the Searcher
    train/    train step, eval step, plateau LR, AdamW, the Trainer and
              its .npz checkpoints
    data/     preprocessing to .npz, the patch pipeline and prefetcher,
              device-side augmentation
    infer/    sliding-window whole-volume inference and the patient loop
    metrics/  BraTS label/region mapping, region Dice, training losses
    io/       NIfTI reading and writing
    utils/    JSON config, metrics logger, device choice, CUDA-event
              timing, the fp32 precision policy, the bounds
    cli.py    preprocess / search / train / predict
              (`python -m nas_3d_unet_tpu_torch`)
    experiments/  the measuring probes E1 (copy bandwidth) and E2 (K1's
              variants on the tensor cores), csrc/probes.cu
    bridge.py flax parameter trees <-> state_dicts

Activations are NDHWC (fp32, or bf16 when training) and parameters keep
flax's names, shapes and fp32.  The package imports no JAX and nothing of
the JAX package.
"""
