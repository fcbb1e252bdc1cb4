"""The benchmark of nas_3d_unet_tpu_torch on one NVIDIA GPU (see
README.md): `python3 benchmark/run.py --workload <cell> --seed <n>
--seconds <s> --trace <0|1>`."""
