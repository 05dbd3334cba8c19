"""Whether what the timed path produced is correct.

After the window, with the program's state freed, the plain float32
reference (TF32 off) runs again. Sampling cells: over a sample of the
requests the window finished, drawn from the seed: `lat_rel`, the
relative L2 gap ‖program − reference‖ / ‖reference‖ of the denoised
latents the program handed to its VAE decode, the worst row's (text
encoding, the UNet on the kernels' route and the solver, without the
decode's bf16 rounding, which hides a lower precision in the UNet from
the pixels); and image by image against what the program returned,
`img_mad`, the mean absolute difference in uint8 levels over every pixel
of a request, and `img_p99`, its 99th percentile; the worst request's of
each. Training cells: over the first
steps the program took in set-up through the window's own call
(`train_gaps`). The limits live in the cell's file
(bench_port/workloads/<cell>.json), with the readings they were set from.
"""
from __future__ import annotations

import gc
import random

import numpy as np
import torch

from bench_port import build
from bench_port.reference import sd15


def latent_gap(got: torch.Tensor, want: torch.Tensor) -> float:
    """The largest row's ‖got − want‖ / ‖want‖."""
    d = (got.double() - want.double()).flatten(1).norm(dim=1)
    return float((d / want.double().flatten(1).norm(dim=1)).max())


def gaps(got: np.ndarray, want: np.ndarray) -> dict:
    d = np.abs(got.astype(np.float64) - want.astype(np.float64))
    return {'img_mad': float(d.mean()),
            'img_p99': float(np.percentile(d, 99)),
            'img_max': float(d.max())}


def sample(done, k: int, seed: int):
    """k of the finished requests, drawn from the seed."""
    done = sorted(done)
    return sorted(random.Random(seed).sample(done, min(k, len(done))))


@torch.inference_mode()
def image_gaps(workload, seed, device, requests) -> list:
    """[{lat_rel, gaps(program, reference)}] of each request, the
    reference built from the seed's draws."""
    sd15.exact_fp32()
    ref = build.reference(workload.cfg, seed, device)
    out = []
    for i in requests:
        lat = workload.reference_latents(ref, i)
        want = workload.decode(ref.vae, lat)
        out.append({'lat_rel': latent_gap(workload.final[i], lat),
                    **gaps(workload.outputs[i], want)})
    del ref
    gc.collect()
    return out


def leaf_gaps(got: dict, want: dict, keep=None) -> list:
    """Each leaf's |‖got‖ − ‖want‖| over the larger of ‖want‖ and the
    median leaf's ‖want‖ (over the leaves `keep`, all by default), as
    [(gap, leaf)] from the largest."""
    keep = list(want) if keep is None else keep
    norms = {k: float(want[k].float().norm()) for k in keep}
    median = float(np.median(list(norms.values())))
    return sorted(((abs(float(got[k].float().norm()) - norms[k]) /
                    max(norms[k], median, 1e-30), k) for k in keep),
                  reverse=True)


def train_gaps(got: dict, want: dict) -> dict:
    """The training check's numbers. `loss_rel`: the largest relative gap
    of a step's loss. `grad_med`, `grad_max`: the median and the worst
    leaf's leaf_gaps of the first gradient, over the leaves the reference
    gives one. `change_med`, `change_max`: the same of the change over
    the checked steps, over the leaves whose first reference gradient is
    at least a thousandth of the median nonzero leaf's (a leaf with no
    gradient moves under Adam by round-off alone)."""
    g = {k: float(v.float().norm()) for k, v in want['grads'].items()}
    median = float(np.median([v for v in g.values() if v > 0]))
    grads = leaf_gaps(got['grads'], want['grads'],
                      [k for k in g if g[k] > 0])
    change = leaf_gaps(got['change'], want['change'],
                       [k for k, v in g.items() if v >= 1e-3 * median])
    return {'loss_rel': max(abs(a - b) / abs(b) for a, b in
                            zip(got['losses'], want['losses'])),
            'grad_med': float(np.median([d for d, _ in grads])),
            'grad_max': grads[0][0],
            'change_med': float(np.median([d for d, _ in change])),
            'change_max': change[0][0]}


def free_program(workload):
    workload.close_program()
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def worst(readings: list) -> dict:
    return {k: max(r[k] for r in readings) for k in readings[0]}
