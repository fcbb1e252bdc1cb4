"""Everything a run feeds the program, made from `--seed`: weights, α,
patients.  Both the program and the reference are handed the same.

The synthetic patients follow chip_smoke.py's `synthetic_records`: four
modalities of N(0, 1) voxels (z-scored, as preprocessing leaves
them) at the extents the traffic file gives (a BraTS scan of 240×240×155
cropped to its foreground box).  Their labels differ from patient to
patient, as tumours do: each patient has its own tumour share of the
voxels (5–65 %) and its own split of the tumour among BraTS's labels 4
(enhancing), 1 (necrotic core) and 2 (oedema), voxel by voxel at random.
They are drawn on the device in a few large calls and held in host
memory, as a dataset is.
"""

from __future__ import annotations

import hashlib
import math
from typing import Dict, List, Mapping, Sequence

import numpy as np
import torch

RAW_SHAPE = (240, 240, 155)


def derive(seed: int, tag: str) -> int:
    """A 63-bit seed for one stream of the run, from `--seed` and a tag."""
    digest = hashlib.sha256(f"{int(seed)}:{tag}".encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1


def generator(seed: int, tag: str, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(derive(seed, tag))
    return g


def make_weights(spec: Mapping[str, tuple], seed: int,
                 device) -> Dict[str, torch.Tensor]:
    """fp32 parameters for `spec` ({name: (shape, kind)}) at flax's
    initialiser scales: kernels truncated normal (±2σ) with variance
    1/fan_in (fan_in: every axis but the last), GroupNorm scales 1, biases
    0.  The kernels come from one draw on `device`."""
    names = sorted(spec)
    kernels = [n for n in names if spec[n][1] == "kernel"]
    sizes = [math.prod(spec[n][0]) for n in kernels]
    g = generator(seed, "weights", device)
    u = torch.rand(sum(sizes), generator=g, device=device,
                   dtype=torch.float64)
    lo = math.erf(-2 / math.sqrt(2))
    z = math.sqrt(2) * torch.erfinv(lo + u * (-2 * lo))   # N(0,1) in ±2
    out: Dict[str, torch.Tensor] = {}
    for n, part in zip(kernels, torch.split(z, sizes)):
        shape = spec[n][0]
        std = math.sqrt(1.0 / math.prod(shape[:-1])) / 0.87962566103423978
        out[n] = (part * std).float().view(shape)
    for n in names:
        shape, kind = spec[n]
        if kind == "scale":
            out[n] = torch.ones(shape, device=device)
        elif kind == "bias":
            out[n] = torch.zeros(shape, device=device)
    return out


def make_alphas(shapes: Mapping[str, tuple], seed: int,
                device) -> Dict[str, torch.Tensor]:
    """DARTS' near-uniform α: 1e-3 times standard normals, one draw."""
    names = sorted(shapes)
    sizes = [math.prod(shapes[n]) for n in names]
    g = generator(seed, "alphas", device)
    z = 1e-3 * torch.randn(sum(sizes), generator=g, device=device)
    return {n: part.view(shapes[n]).clone()
            for n, part in zip(names, torch.split(z, sizes))}


def make_patients(seed: int, tag: str, shapes: Sequence[Sequence[int]],
                  channels: int, device, labels: bool = True) -> List[dict]:
    """Synthetic patients, host arrays: "image" (D, H, W, C) fp32 and, with
    `labels`, "label_u8" (D, H, W) in {0, 1, 2, 4}."""
    g = generator(seed, tag, device)
    out = []
    for shape in shapes:
        shape = tuple(int(s) for s in shape)
        rec = {"image": torch.randn((*shape, channels), generator=g,
                                    device=device).cpu().numpy()}
        if labels:
            r = torch.rand(3, generator=g, device=device).tolist()
            tumour = 0.05 + 0.6 * r[0]
            et = 0.2 + 0.6 * r[1]                 # shares of the tumour
            ncr = (1 - et) * r[2]
            u = torch.rand(shape, generator=g, device=device) / tumour
            lab = torch.where(u >= 1, 0, torch.where(
                u < et, 4, torch.where(u < et + ncr, 1, 2)))
            rec["label_u8"] = lab.to(torch.uint8).cpu().numpy()
        out.append(rec)
    return out


def crop_start(shape: Sequence[int]) -> np.ndarray:
    """Where a cropped volume of `shape` sits in the raw scan: centred."""
    return np.asarray([(r - s) // 2 for r, s in zip(RAW_SHAPE, shape)],
                      np.int64)


class PatientPool:
    """Patients held in host memory in the shape the program's patch
    generator reads (`records`, `label_mode`, len)."""

    def __init__(self, records: List[dict], label_mode: str = "regions"):
        self.records, self.label_mode = records, label_mode

    def __len__(self) -> int:
        return len(self.records)
