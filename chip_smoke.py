#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (mixofshow_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each raises on failure; the script exits non-zero without a result
line when any fails, or when no CUDA device is visible):
  1. device   — the card's name and power limit (nvidia-smi);
  2. build    — nvcc-builds the CUDA kernels from csrc/ into .torch_ext/ (one
                process per source, in parallel) and JIT-compiles the Triton
                kernels (K2, and K8 with and without SiLU), timing each;
  3. kernels  — each kernel against its plain PyTorch version on the same
                inputs at the main paths' shapes (K1, K2, K3 and K8 also at
                a validation batch of 4 prompts: K1 at batch 8 with CFG, K2
                and K8 at the decoder's six GroupNorm shapes with their
                launch-weighted sums over a decode; K1, K3, K7, K2 and K8
                also at phase 9's wide canvases, 512x1024 with 2 images and
                1024x2048 with 1: K1 up to 32,768 keys, held against its
                twin on the first, middle and last 512 query rows where
                the twin's whole score matrix would not fit, K3 at 8,192
                and 32,768 tokens, K7 on the wide grids, 8x16 the
                smallest, with the layouts' boxes and regionally_sample.sh's
                boxes past the canvas's lower edge, K2 and K8 at the 2x
                decoder's six shapes), error against a stated
                bound, both device times from CUDA events (the calls
                queued behind a sleep kernel), the least time the card
                could take (bound_ms: bytes over 3.35 TB/s or operations
                over their peak rate, whichever is longer) and, where one
                PyTorch call computes the same function, that call's time
                (library_ms; K2's is torch.var_mean, whose mean and
                variance give Σx and Σx²), K3 also by its three launches (the grouped
                q/k/v GEMM, the wide core, the out-projection); K1's
                planted faults (a 64-key tile, the ragged last tile, the
                kv_len mask left out of the twin) over its bf16 bound; K7
                also at three overlapping boxes, its planted faults (a
                region's context left out, the global context inside a
                box, a box moved one pixel row, the overlap count ignored)
                over its bf16 bound; the
                flash kernels (K4-K6) also in fp32 against
                autograd of the plain attention, a backward rerun that must
                be bit-identical, and a planted fault (the plain backward
                without Dvec) that must come out over the bf16 bound; K8 at
                the VAE decoder's GroupNorm shapes, its planted faults (a
                and b swapped, SiLU dropped) over its bf16 bound, and its
                backward against autograd of the plain version; K4's
                forward also at the int8 serving requests' shapes
                (FLASH_INFERENCE), with SDPA's time; K1 and K4 through each
                bf16 design of csrc/attn_fwd.cu that takes the shape
                (ping-pong and lock-step up to D 80, the route passed
                explicitly), each within the bound and timed beside SDPA;
  3b. int8    — the int8 serving modes' dense pool (INT8_DENSE, phase 5's
                request's GEGLU, projections and cross K/V) and resnet convs
                (INT8_CONV): the card's int32 accumulators against exact
                integer products, the round trip (absmax, quantize,
                torch._int_mm, rescale; im2col for a conv) against the bf16
                product, each with its least time; one line INT8_TABLE
                {json} before the result;
  4. wiring   — the tiny config in fp32 (TF32 off) at 512x512 on the card
                and on the CPU: EDLoRAPipeline, 2 steps (K1, K2, K3, K8
                launch, no flash kernel) and RegionallyT2IAdapterPipeline
                with 2 regions and a keypose adapter (K7 too), images
                compared; one EDLoRATrainer loss and backward (10 launches
                each of K4, K5, K6, none of K1), loss and every gradient
                group compared; a two-concept fusion through
                compose_concepts (2 spatial steps, 64x64, the CPU's latents
                on both), every solved kernel compared;
  5. main     — ED-LoRA path: SD1.5-width UNet, CLIP and VAE in bf16,
                random weights from a seeded generator on the card, two
                concept tokens; two requests of 2 prompts at 512x512, CFG
                7.5, 50 DPM-Solver++ steps, one through __call__ and one
                through submit().result(), uint8 output. Checks shapes, that
                the images are not constant and identical across the two
                requests (same latents), and that K1, K2 and K3 launched;
                then a third request with a utils.ptp.AttentionStore
                attached: maps of exactly the 11 layers with at most 32²
                queries, rows summing to 1 over the 77 keys within 1e-3,
                and images within one uint8 level of the first request's
                (the share that is identical printed);
  5q. int8    — phase 5's request on the same modules with quantize='int8'
                and 'int8+conv', two requests each: finite images, not
                constant, the two identical; per request K1 0 and K4 500
                (a quantized attn1 leaves the packed route), K2/K8 30 and
                K3 1; prints the seconds beside the bf16 request's, the
                peak memory and the relative L2 difference from the bf16
                images (reported, not gated);
  6. regional — regional path: the same widths plus a full-width keypose
                adapter, three concepts in three boxes (bench.py's layout),
                the repository's keypose image, 2 images at 512x512, CFG
                7.5, 50 steps, one request through __call__ and one through
                submit().result(). Checks as in 5, and that every request
                launched K7 16 x 50 times and K1, K2, K3 too;
  6q. int8    — phase 6's request in both int8 modes, as 5q (K7 800 a
                request besides);
  7. train    — ED-LoRA training at SD1.5 width through the port's CLI
                (train_edlora.main, in-process) on the repository's config
                options/train/EDLoRA/real/EDLoRA_hermione_B4_Repeat500.yml
                (bf16, batch 2 at 512x512, rank-4 LoRA on text and UNet
                attention, the reference learning rates, attention
                regularization, val_during_save true), overriding only the
                data (a seeded synthetic concept, 4 images 640x512 with
                captions and masks, in a temporary directory), random:sd15
                weights, 6 steps with a save every 3 (SAVE_FREQ), the
                validation set cut to 1 sample a prompt (8 prompts x 3
                alphas, batches of 4, 50 steps, CFG 7.5) and a log line
                every step. Checks a finite loss at every step; per step 10
                launches each of K4, K5, K6, no K1, one K3 and the
                encoder's K2 and K8 counts; per validation request 500 K1,
                30 K2, 30 K8 and one K3 (VAL_REQUEST); that the embedding,
                the text LoRA and the UNet LoRA (every attn1 leaf included)
                moved; the deltas and train_state-{3,6,latest}.pt, the
                latest delta reloading with the reference keys; and the
                PNGs and grid of every Iters-<tag>_Alpha-<alpha> sweep.
                Prints the steady s/step over the steps that did not save,
                each sweep's seconds and the peak device memory;
  7b. resume  — the same CLI on the same config with validation off and
                --resume <experiment>/models/train_state-3.pt: the relaunch
                archives phase 7's experiment and the CLI follows the
                checkpoint there. Checks that the state it loaded equals
                the file bitwise (every tensor, the AdamW moments and step,
                the schedule, emb_frozen and step), steps 4 to 6 with phase
                7's launches a step and finite losses, the logged learning
                rates equal to phase 7's at those steps and the final ones
                to phase 7's exactly;
  7c. sweep   — test_edlora.main on phase 7's last delta with
                options/test/EDLoRA/real/EDLoRA_hermione_test.yml
                (random:sd15 at the training seed, the validation set cut to
                1 sample a prompt): 6 requests of VAL_REQUEST launches, 8
                PNGs and a grid an alpha; alpha 0 bit-identical to an
                EDLoRAPipeline without LoRA on the same concept table and
                latents; alpha 1.0 within one uint8 level of phase 7's last
                validation at alpha 1.0 (the share that is identical
                printed);
  7d. ddp     — phase 7's config with validation off through
                `python -m torch.distributed.run --standalone
                --nproc_per_node 1 -m mixofshow_tpu_torch.train_edlora
                --device cuda` in a subprocess (one card hosts one NCCL
                rank; tools/port_ddp_cards.py runs worlds 2 and 4 on as
                many cards): the process
                group is NCCL, the train states and deltas at every save
                equal phase 7's bitwise, the logged losses phase 7's;
  8. fusion   — gradient fusion at SD1.5 width through the port's CLI
                (gradient_fusion.main, in-process) at fuse.sh's operating
                point (exact solve, 20 spatial steps, 512, bf16 capture) on
                random:sd15, of three concepts shaped like
                datasets/data_cfgs/multi-concept/real/
                potter+hermione+thanos_chilloutmix.json: <hermione1>
                <hermione2> is phase 7's trained delta, the other two are
                seeded rank-4 LoRAs on the reference finetune_cfg's layers.
                Checks 48 text, 32 cross-KV and 96 spatial layers solved
                with finite residuals, exactly 10 K4 launches per capture
                eval and no other kernel, that the fused weights differ
                from the base exactly where a delta had a leaf, and that
                the directory reloads (vocabulary 49408 + 96); then one
                regional request of phase 6's layout on the fused model
                (K7 16 x 50 times, images not constant); the fused
                directory is kept for phase 9;
  9. cli      — the port's regional CLI (regionally_controlable_sampling
                .main, in-process, argv as a user gives it) on phase 8's
                fused directory, with a seeded full-width keypose adapter
                written in the TencentARC layout (pytorch_model.bin) and a
                sketch adapter in the diffusers layout (prefixed
                safetensors): each converted adapter's features equal the
                seeded module's bitwise, and the CLI never takes its
                random-adapter branch. 9a: the real_pose layout
                potter_hermione_thanos.txt (3 boxes, its pose and sketch
                images, a 512x1024 canvas), 2 images, seed 19, 50 steps;
                9b: real_pose_2x/potter_hermione_thanos_2x.txt with its
                pose image, 1024x2048, 1 image; 9c: regionally_sample.sh's
                own arguments (2 boxes past the lower edge), 1 image. Each
                checks the PNGs and .txt files under the hashed names (the
                hash the sha256 of the .txt), images of the canvas size and
                not constant (9a's two differ), and the launches of one
                request: K1 500 (750 at 1024x2048), K7 800, K2 and K8 30,
                K3 1, no flash kernel; K1's by design: 500 ping-pong (the
                heads 40 and 80 wide, 32,768 keys among them at 1024x2048)
                and the 250 of 160-wide heads lock-step. Prints the load,
                sampling and save seconds and the peak device memory.
Phases 5 and 6 also check that no flash kernel launched, and print the
convolutions by input layout (layers.conv2d.layouts) over their two
requests: every UNet conv of the 100 evals on channels-last input, the
VAE's and the adapter's NCHW ('other'). Then the INT8_TABLE
line, one JSON line with the kernels (launches: phases 5 to 9 together, 5q,
6q, 7b and 7c included; 7d runs in its own process), the nvidia-smi line,
and the last line {"ok": true, "device": {...}}.
"""
import contextlib
import copy
import hashlib
import io
import json
import logging
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch
from PIL import Image

import yaml
from torch import nn

import torch.nn.functional as F

from mixofshow_tpu_torch import (gradient_fusion, ops, test_edlora,
                                 train_edlora, zoo)
from mixofshow_tpu_torch import regionally_controlable_sampling as \
    regional_cli
from mixofshow_tpu_torch.convert import (convert_edlora_delta,
                                         load_edlora_delta, safetensors_io,
                                         save_edlora_delta)
from mixofshow_tpu_torch.data import PromptDataset
from mixofshow_tpu_torch.fusion import compose_concepts
from mixofshow_tpu_torch.fusion.gradient_fusion import layer_kernel
from mixofshow_tpu_torch.models import (CLIPTextConfig, CLIPTextModel, UNet,
                                        UNetConfig, layers)
from mixofshow_tpu_torch.models.lora import flatten_lora, init_lora_tree
from mixofshow_tpu_torch.models.t2i_adapter import preprocess_adapter_image
from mixofshow_tpu_torch.models.unet import cross_layer_query_sizes
from mixofshow_tpu_torch.ops import _build
from mixofshow_tpu_torch.ops import flash_attention as fl
from mixofshow_tpu_torch.ops import fused_attention as fa
from mixofshow_tpu_torch.ops import gn_stats as gs
from mixofshow_tpu_torch.ops import quant
from mixofshow_tpu_torch.ops import region_attention as ra
from mixofshow_tpu_torch.ops.solve import output_difference
from mixofshow_tpu_torch.pipelines import (EDLoRAPipeline,
                                           RegionallyT2IAdapterPipeline,
                                           bind_concept_prompt,
                                           init_concepts)
from mixofshow_tpu_torch.pipelines.trainer_edlora import EDLoRATrainer
from mixofshow_tpu_torch.pipelines.validation import visual_validation
from mixofshow_tpu_torch.text import CLIPTokenizer
from mixofshow_tpu_torch.utils.device import exact_fp32, require_cuda
from mixofshow_tpu_torch.utils.options import resolve_compute_dtype
from mixofshow_tpu_torch.utils.ptp import AttentionStore

# K3 bf16 against the fp32 plain version on the same bf16 inputs: P and the
# output are rounded to bf16 (2^-8 relative), so a few 1e-3 is expected;
# 3e-2 is the bound the JAX suite uses for its bf16 attention kernels
# (tests/test_ops.py).
ATTN_BOUND = 3e-2
# K7 bf16 against its twin on the same bf16 inputs (fp32 math, the output
# rounded to bf16): the kernel also rounds P to bf16 for P·V, so the two
# differ by about one bf16 ulp of the output, at most 2^-7 of max|twin|;
# the planted faults (_region_faults) must come out over it
REGION_BF16_REL = 1e-2
# K1 bf16 against its twin on the same bf16 inputs (q̃ = bf16(q·scale) and
# the output rounded to bf16 in both): the largest error relative to the
# twin's largest entry. The two round the same fp32 values to within ~1e-4,
# so they differ by at most one bf16 ulp, 2^-7 = 7.8e-3 of max|twin|; the
# planted faults (_attn_faults) must come out over it, and phase 3 prints
# how far
ATTN_BF16_REL = 1e-2
# bf16 flash kernels (K4-K6), the training path's: the largest error
# relative to the twin's largest entry (one bf16 ulp there is 2^-8 to 2^-7
# of it), tight enough that a backward dropping Dvec from dS is over it
# (phase 3 shows that it is); the fp32 LSE absolute
FLASH_BF16_REL = 2e-2
FLASH_LSE_BOUND = 1e-3
# fp32 sums over up to 262144 elements, relative to the sum of magnitudes
SUMS_BOUND = 1e-4
# fp32 flash kernels against their twins and against autograd of the plain
# attention: fp32 sums over up to 4096 keys in another order
FLASH_F32_BOUND = 1e-4
# tiny fp32 pipeline, card vs CPU, pixels in [0, 1]
WIRING_BOUND = 2e-3
# tiny fp32 train step, card vs CPU: the loss, and each gradient group's
# largest difference relative to its largest entry (fp32 sums in another
# order through the UNet, CLIP and the VAE encode)
WIRING_TRAIN_BOUND = 1e-3
# tiny fp32 fusion, card vs CPU: each solved layer's outputs on its captured
# features, ‖X(W_card − W_cpu)‖ / ‖X(W_cpu − W₀)‖ (ops.solve
# .output_difference). The kernels' largest difference relative to max|ΔW|
# is printed beside it: cuSOLVER and LAPACK keep or drop eigenvalues within
# an fp32 ulp of e_max of the rank cutoff differently, which moves kernel
# entries along directions the data hardly sees
WIRING_FUSION_BOUND = 1e-3
# K8: bf16 one ulp at the top binade of the twin (2^-7 of max|twin|: both
# round x·a and + b to bf16, the SiLU's fp32 exp may differ by an ulp), fp32
# 1e-6 of max|twin| (an FMA, and the exp, in another order)
APPLY_BOUND = {torch.bfloat16: 2.0 ** -7, torch.float32: 1e-6}
# its plain backward against autograd of the plain forward, fp32: da and db
# sum 1024 terms in another order
APPLY_BWD_BOUND = 1e-5
TRAIN_STEPS = 6
# phase 7 saves (and validates) every SAVE_FREQ steps and at the end; its
# validation set is cut to VAL_SAMPLES samples a prompt
SAVE_FREQ = 3
VAL_SAMPLES = 1
# one validation request of 4 prompts (CFG batch 8), 50 steps: K1 at the
# UNet's 10 self-attentions of 1024 and 4096 keys an eval, K2 and K8 at the
# decoder's 30 GroupNorms, K3 at its mid-block attention
VAL_REQUEST = {'attn_fwd': 10 * 50, 'gn_spatial_sums': 30, 'gn_apply': 30,
               'attn_block': 1}
FUSION_STEPS = 20
# the H100 SXM's published peaks (NVIDIA's data sheet): HBM3 bytes/s,
# dense bf16 tensor-core and fp32 CUDA-core operations/s
PEAK_BYTES = 3.35e12
PEAK_BF16 = 989e12
PEAK_FP32 = 67e12
# ... and dense int8 tensor-core operations/s
PEAK_INT8 = 1979e12
# cycles of the sleep kernel cuda_ms queues its calls behind (~50 ms)
SLEEP_CYCLES = 100_000_000

KERNEL_META = {
    'attn_fwd': ('cuda', 'mixofshow_tpu_torch/csrc/attn_fwd.cu',
                 'mixofshow_tpu/ops/fused_attention.py:248'),
    'gn_spatial_sums': ('triton', 'mixofshow_tpu_torch/ops/gn_stats_triton.py',
                        'mixofshow_tpu/ops/gn_stats.py:29'),
    'attn_block': ('cuda', 'mixofshow_tpu_torch/csrc/attn_wide.cu',
                   'mixofshow_tpu/ops/fused_attention.py:63'),
    'region_attn': ('cuda', 'mixofshow_tpu_torch/csrc/region_attn.cu',
                    'mixofshow_tpu/ops/region_attention.py:66'),
    'flash_fwd': ('cuda', 'mixofshow_tpu_torch/csrc/attn_fwd.cu',
                  'mixofshow_tpu/ops/flash_attention.py:50'),
    'flash_bwd_dkv': ('cuda', 'mixofshow_tpu_torch/csrc/flash_bwd_dkv.cu',
                      'mixofshow_tpu/ops/flash_attention.py:181'),
    'flash_bwd_dq': ('cuda', 'mixofshow_tpu_torch/csrc/flash_bwd_dq.cu',
                     'mixofshow_tpu/ops/flash_attention.py:234'),
    'gn_apply': ('triton', 'mixofshow_tpu_torch/ops/gn_stats_triton.py',
                 'mixofshow_tpu/ops/gn_stats.py:101'),
}
# the VAE decoder's GroupNorm inputs (C, H, W) at 512x512 and how many of
# its 30 norms have each (each launches K2 and K8 once)
DECODE_NORMS = [((512, 64, 64), 11), ((512, 128, 128), 6),
                ((512, 256, 256), 1), ((256, 256, 256), 5),
                ((256, 512, 512), 1), ((128, 512, 512), 6)]
# ... of the 2x decoder (a 1024x2048 canvas)
DECODE_NORMS_2X = [((512, 128, 256), 11), ((512, 256, 512), 6),
                   ((512, 512, 1024), 1), ((256, 512, 1024), 5),
                   ((256, 1024, 2048), 1), ((128, 1024, 2048), 6)]
# K1's plain twin holds fp32 scores for every (batch, head, query, key);
# past this many bytes it runs on TWIN_ROWS rows of each end and the middle
TWIN_SCORE_BYTES = 16 * 2 ** 30
TWIN_ROWS = 512
FLASH_KERNELS = ('flash_fwd', 'flash_bwd_dkv', 'flash_bwd_dq')
# K4 at the int8 serving requests' shapes (phases 5q and 6q: a quantized
# attn1 leaves K1 for sdpa's flash route): 512x512, 2 images with CFG, the
# res-64 and res-32 self-attentions
FLASH_INFERENCE = [(4, 4096, 8, 40), (4, 1024, 8, 80)]
# the int8 serving modes' dense pool at phase 5's request (CFG batch 4 at
# 512x512), (name, rows, K, N): the GEGLU in/out at res 64 and 32, the
# attention projections at res 64, 32 and 16, the hoisted cross K/V
INT8_DENSE = [('geglu64_in', 4 * 4096, 320, 2560),
              ('geglu64_out', 4 * 4096, 1280, 320),
              ('geglu32_in', 4 * 1024, 640, 5120),
              ('geglu32_out', 4 * 1024, 2560, 640),
              ('proj64', 4 * 4096, 320, 320),
              ('proj32', 4 * 1024, 640, 640),
              ('proj16', 4 * 256, 1280, 1280),
              ('cross_kv', 4 * 77, 768, 320)]
# ... and its resnet 3x3 convs at res 64 ('int8+conv'), (B, C, H, W)
INT8_CONV = [('conv64', (4, 320, 64, 64)), ('conv32', (4, 640, 32, 32))]
# one int8 request's launches beside the bf16 request's: attn1's 500 K1
# launches become K4's
QUANT_REQUEST = {'attn_fwd': 0, 'flash_fwd': 10 * 50, 'flash_bwd_dkv': 0,
                 'flash_bwd_dq': 0, 'gn_spatial_sums': 30, 'gn_apply': 30,
                 'attn_block': 1, 'region_attn': 0}
PLAIN_PATH_KERNELS = ('attn_fwd', 'gn_spatial_sums', 'attn_block',
                      'gn_apply')
SAMPLING_KERNELS = PLAIN_PATH_KERNELS + ('region_attn',)
# bench.py's three near-full-height boxes, (start_h, start_w, end_h, end_w)
REGIONS = [('a <potter1> <potter2>, in a jacket', 'low quality',
            [0.02, 0.05, 0.95, 0.30]),
           ('a <hermione1> <hermione2>, in a dress', 'low quality',
            [0.02, 0.35, 0.95, 0.62]),
           ('a <thanos1> <thanos2>, with armor', 'low quality',
            [0.02, 0.68, 0.95, 0.97])]
# three overlapping boxes, two on the grid's edges (phase 3's K7 check)
OVERLAP_BOXES = [[0.0, 0.0, 0.6, 0.6], [0.3, 0.3, 0.9, 0.9],
                 [0.2, 0.5, 1.0, 1.0]]
CONCEPTS = '<potter1> <potter2>+<hermione1> <hermione2>+<thanos1> <thanos2>'
ROOT = Path(__file__).resolve().parent
LAYOUTS = ROOT / 'datasets' / 'validation_spatial_condition' / \
    'multi-characters'
POSE = LAYOUTS / 'real_pose' / 'potter_hermione_thanos_pose.png'
# phase 9's layouts: 3 characters at 512x1024 and at 1024x2048
LAYOUT_1X = LAYOUTS / 'real_pose' / 'potter_hermione_thanos.txt'
LAYOUT_2X = LAYOUTS / 'real_pose_2x' / 'potter_hermione_thanos_2x.txt'
SAMPLE_SH = ROOT / 'regionally_sample.sh'
# the repository's ED-LoRA training config; phase 7 overrides only the data,
# the weights, the length, the save frequency, the validation samples and
# logging
TRAIN_YML = ROOT / 'options' / 'train' / 'EDLoRA' / 'real' / \
    'EDLoRA_hermione_B4_Repeat500.yml'
# its validation sweep's config, for the test_edlora phase
TEST_YML = ROOT / 'options' / 'test' / 'EDLoRA' / 'real' / \
    'EDLoRA_hermione_test.yml'


def read_layout(path):
    """A layout file's shell assignments (key='value') as a dict."""
    return dict(re.findall(r"^(\w+)='(.*)'\s*$", Path(path).read_text(),
                           re.M))


def layout_rewrite(layout):
    """The region string regionally_sample.sh builds, from a layout file:
    '[char]-*-[context_neg_prompt]-*-box|...'."""
    neg = layout['context_neg_prompt']
    n = len([k for k in layout if re.fullmatch(r'char\d+', k)])
    return '|'.join(f"[{layout[f'char{i}']}]-*-[{neg}]-*-{layout[f'box{i}']}"
                    for i in range(1, n + 1))


def sample_sh_args():
    """regionally_sample.sh's variables (its prompt_rewrite built as the
    script builds it)."""
    text = SAMPLE_SH.read_text()
    var = dict(re.findall(r"^(\w+)='([^']*)'$", text, re.M))
    var.update(re.findall(r'^(\w+)="([^"]*)"$', text, re.M))
    var.update(re.findall(r'^(\w+)=([^\'"\s]\S*)$', text, re.M))
    neg = var['context_neg_prompt']
    var['prompt_rewrite'] = '|'.join(
        f"{var[f'region{i}_prompt']}-*-[{neg}]-*-{var[f'region{i}']}"
        for i in (1, 2))
    return var


def layout_boxes(rewrite, height, width):
    """The normalized boxes the CLI makes of a region string."""
    return [box for _, _, box in
            regional_cli.prepare_text('', rewrite, height, width)[1]]


def check(cond, msg):
    if not cond:
        raise RuntimeError(msg)


def cuda_ms(fn, iters=10, warmup=2):
    """Device milliseconds per call: the calls are queued behind a sleep
    kernel (~50 ms, far longer than their enqueue), so CUDA events around
    them time the card and not the host's launch cost."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SLEEP_CYCLES)
    start.record()
    for _ in range(iters):
        fn()
    late = start.query()   # the sleep ran out while the host still queued
    end.record()
    end.synchronize()
    check(not late, 'cuda_ms: the host queued the calls slower than the '
          'sleep in front of them; the time would be the host\'s')
    return start.elapsed_time(end) / iters


def smi_line():
    out = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()
    return out[0]


def least_time(nbytes, operations, peak_ops):
    """(bound_ms, bound_by): the least time the card could take, the longer
    of the bytes at PEAK_BYTES and the operations at `peak_ops`."""
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_ops = operations / peak_ops * 1e3
    return (t_bytes, 'bytes') if t_bytes >= t_ops else (t_ops, 'operations')


def nbytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts)


def row(err, ms, plain_ms, bnd, library_ms=None):
    return {'max_abs_err': err, 'ms': ms, 'plain_ms': plain_ms,
            'bound_ms': bnd[0], 'bound_by': bnd[1], 'library_ms': library_ms}


def sdpa_ms(q, k, v):
    """One F.scaled_dot_product_attention call on (B, S, H, D) tensors (as
    (B, H, S, D) views)."""
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    return cuda_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt))


def attn_flops(b, h, sq, sk, d, products):
    """Tensor-core operations of `products` (Sq x Sk x D) matrix products
    per (batch, head)."""
    return 2 * products * b * h * sq * sk * d


def phase_build(dev):
    t0 = time.perf_counter()
    _build.cuda_lib()
    t_cuda = time.perf_counter() - t0
    t0 = time.perf_counter()
    ab = torch.ones(1, 8, device=dev)
    for dt in (torch.bfloat16, torch.float32):
        x = torch.ones(1, 8, 4, 4, device=dev, dtype=dt)
        gs.spatial_sums(x)
        for act in gs.ACTS:
            gs.scale_bias_act(x, ab, ab, act)
    torch.cuda.synchronize()
    t_triton = time.perf_counter() - t0
    print(f'[build] nvcc K1 K3 K4-K7 library (one nvcc per csrc source, '
          f'in parallel): {t_cuda:.2f} s '
          f'({_build.library_path().name}); Triton K2 + K8 JIT (bf16+fp32, '
          f'K8 with and without SiLU): {t_triton:.2f} s', flush=True)


def phase_kernels(dev):
    """Each kernel vs its plain version; returns {name: (err, ms, plain_ms)}
    at the first (main-path) shape of each, the flash kernels' included."""
    g = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape, scale=1.0):
        return (torch.randn(*shape, generator=g, device=dev) * scale) \
            .to(torch.bfloat16)

    res = {}
    # K1 at the UNet's res-64 and res-32 self-attention (CFG batch of 2
    # prompts), a ragged kv_len, the widest head of its wgmma kernel, the
    # validation sweeps' (CFG batch of 4 prompts), and phase 9's wide
    # canvases: 512x1024 at CFG batch 4 (8192 and 2048 tokens), 1024x2048
    # at CFG batch 2 (32768, 8192 and 2048)
    for b, s, h, d, sk, kvl in [(4, 4096, 8, 40, 4096, 4096),
                                (4, 1024, 8, 80, 1024, 1024),
                                (2, 1000, 8, 40, 1100, 1037),
                                (2, 256, 8, 160, 1024, 1024),
                                (8, 4096, 8, 40, 4096, 4096),
                                (8, 1024, 8, 80, 1024, 1024),
                                (4, 8192, 8, 40, 8192, 8192),
                                (4, 2048, 8, 80, 2048, 2048),
                                (2, 32768, 8, 40, 32768, 32768),
                                (2, 8192, 8, 80, 8192, 8192),
                                (2, 2048, 8, 160, 2048, 2048)]:
        q, k, v = randn(b, s, h, d), randn(b, sk, h, d), randn(b, sk, h, d)
        rows = _twin_rows(b, h, s, sk, dev)
        qs = q if rows is None else q[:, rows]
        ref = fa.attn_fwd_plain(qs, k, v, kvl)
        fault = min(_flash_err(f, ref) for f in _attn_faults(qs, k, v, kvl))
        pms = cuda_ms(lambda: fa.attn_fwd_plain(qs, k, v, kvl))
        bnd = least_time(nbytes(q, k[:, :kvl], v[:, :kvl], q),
                    attn_flops(b, h, s, kvl, d, 2), PEAK_BF16)
        # a ragged kv_len: SDPA over the first kv_len keys
        lib = sdpa_ms(q, k[:, :kvl], v[:, :kvl])
        subset = '' if rows is None else \
            f' (twin on {len(rows)} of {s} query rows: the first, middle ' \
            f'and last {TWIN_ROWS})'
        shipped = fl.launch_route(q, k, v)
        # every design that takes the shape, the route passed explicitly
        for route in attn_designs(d):
            out = fa.attn_fwd(q, k, v, kvl, _route=route)
            got = out if rows is None else out[:, rows]
            err, rel = _max_err(got, ref), _flash_err(got, ref)
            ms = cuda_ms(lambda: fa.attn_fwd(q, k, v, kvl, _route=route))
            print(f'[kernels] attn_fwd (B,S,H,D)=({b},{s},{h},{d}) Sk={sk} '
                  f'kv_len={kvl} {route}'
                  f'{" (shipped)" if route == shipped else ""}: error vs '
                  f'twin {rel:.3e} of max|twin| (bound {ATTN_BF16_REL}), '
                  f'max_abs_err {err:.3e}; planted fault {fault:.3e} (must '
                  f'exceed {ATTN_BF16_REL}){subset}; kernel {ms:.4f} ms, '
                  f'plain {pms:.4f} ms, least {bnd[0]:.4f} ms ({bnd[1]}), '
                  f'SDPA {lib:.4f} ms', flush=True)
            check(math.isfinite(rel) and rel <= ATTN_BF16_REL,
                  f'attn_fwd ({route}) disagrees')
            if route == shipped:
                res.setdefault('attn_fwd', row(err, ms, pms, bnd, lib))
        check(fault > ATTN_BF16_REL,
              f'attn_fwd bound {ATTN_BF16_REL} does not reject the planted '
              'fault')
        # heads up to 80 wide (the 2x canvas's res-128 layer among them)
        # take the ping-pong design
        check(d > 80 or shipped == 'pingpong',
              f'attn_fwd at D {d} routes to {shipped}')
    # K2 at the VAE decoder's GroupNorm inputs, NCHW, each with its
    # launches a decode (DECODE_NORMS): 2 images (the main path) and 4 (a
    # validation batch); 1 image of the 2x decoder (DECODE_NORMS_2X,
    # phase 9b); the launch-weighted sums over a whole decode. Library:
    # torch.var_mean (Σx = n·mean, Σx² = n·(var + mean²))
    for batch, norms in ((2, DECODE_NORMS), (4, DECODE_NORMS),
                         (1, DECODE_NORMS_2X)):
        tot = {'ms': 0.0, 'bound': 0.0, 'n': 0, 'lib': 0.0}
        for chw, n in norms:
            shape = (batch, *chw)
            x = randn(*shape)
            s1, s2 = gs.spatial_sums(x)
            r1, r2 = gs.spatial_sums_plain(x)
            mag = x.float().abs().sum(dim=(2, 3))
            err = max((s1 - r1).abs().max().item(),
                      (s2 - r2).abs().max().item())
            rel = max(((s1 - r1).abs() / mag).max().item(),
                      ((s2 - r2).abs() / r2).max().item())
            ms = cuda_ms(lambda: gs.spatial_sums(x))
            pms = cuda_ms(lambda: gs.spatial_sums_plain(x))
            lib = cuda_ms(lambda: torch.var_mean(x, dim=(2, 3),
                                                 correction=0))
            bnd = least_time(nbytes(x, s1, s2), 3 * x.numel(), PEAK_FP32)
            print(f'[kernels] gn_spatial_sums (B,C,H,W)={shape} ({n} a '
                  f'decode): max_abs_err {err:.3e}, relative {rel:.3e} '
                  f'(bound {SUMS_BOUND}); kernel {ms:.4f} ms, plain '
                  f'{pms:.4f} ms, least {bnd[0]:.4f} ms ({bnd[1]}), '
                  f'var_mean {lib:.4f} ms', flush=True)
            check(math.isfinite(rel) and rel <= SUMS_BOUND,
                  'gn_spatial_sums disagrees')
            tot['ms'] += n * ms
            tot['bound'] += n * bnd[0]
            tot['n'] += n
            tot['lib'] += n * lib
            if shape == (2, 128, 512, 512):
                res['gn_spatial_sums'] = row(err, ms, pms, bnd, lib)
        print(f'[kernels] gn_spatial_sums over one decode of {batch} '
              f'images at {norms[-1][0][1]}x{norms[-1][0][2]} '
              f'({tot["n"]} launches): {tot["ms"]:.4f} ms, least '
              f'{tot["bound"]:.4f} ms ({tot["bound"] / tot["ms"]:.1%} of '
              f'the least time), var_mean {tot["lib"]:.4f} ms', flush=True)
    # K3 at the VAE mid-block: C=512, one head; 64x64 tokens with 2 images
    # (the main path) and 4 (a validation batch), 64x128 with 2 and
    # 128x256 with 1 (phase 9's canvases)
    c = 512
    for b, s in ((2, 4096), (4, 4096), (2, 8192), (1, 32768)):
        x = randn(b, s, c)
        w = [randn(c, c, scale=c ** -0.5) for _ in range(4)]
        bias = [randn(c, scale=0.1) for _ in range(4)]
        args = (x, x, *w, bias[3], 1, *bias[:3])
        out = fa.attention_block(*args)
        ref = fa.attention_block_plain(*(a.float() if torch.is_tensor(a)
                                         else a for a in args))
        err = (out.float() - ref).abs().max().item()
        ms = cuda_ms(lambda: fa.attention_block(*args))
        pms = cuda_ms(lambda: fa.attention_block_plain(*args))

        def library():  # four F.linear and SDPA, one head
            q, k, v = (F.linear(x, w[i], bias[i])[:, None]
                       for i in range(3))
            o = F.scaled_dot_product_attention(q, k, v)[:, 0]
            return F.linear(o, w[3], bias[3])

        bnd = least_time(nbytes(x, *w, *bias, out),
                         4 * 2 * b * s * c * c +
                         attn_flops(b, 1, s, s, c, 2), PEAK_BF16)
        lib = cuda_ms(library)
        # its three launches apart: the grouped q/k/v GEMM, the core, the
        # out-projection
        x2 = x.view(-1, c)
        qkv = [(x2, w[i], bias[i], c ** -0.5 if i == 0 else 1.0)
               for i in range(3)]
        q, k, v = (t.view(b, s, 1, c) for t in fa._gemm_grouped(qkv))
        o = torch.empty_like(q)
        parts = {'q/k/v GEMM': cuda_ms(lambda: fa._gemm_grouped(qkv)),
                 'core': cuda_ms(lambda: fl.launch_fwd(q, k, v, o,
                                                       scale=1.0)),
                 'out GEMM': cuda_ms(lambda: fa._gemm_grouped(
                     [(o.view(-1, c), w[3], bias[3], 1.0)]))}
        print(f'[kernels] attn_block (B,S,C)=({b},{s},512) heads=1 with '
              f'biases: max_abs_err {err:.3e} (bound {ATTN_BOUND}); kernel '
              f'{ms:.4f} ms ('
              + ', '.join(f'{n} {t:.4f}' for n, t in parts.items())
              + f' ms), plain {pms:.4f} ms, least {bnd[0]:.4f} ms '
              f'({bnd[1]}), four F.linear + SDPA {lib:.4f} ms', flush=True)
        check(math.isfinite(err) and err <= ATTN_BOUND,
              'attn_block disagrees')
        res.setdefault('attn_block', row(err, ms, pms, bnd, lib))
    # K7 at the regional path's cross-attention layers: 8 heads, 77 keys;
    # phase 6's square grids (2 images x CFG) with the three boxes of
    # REGIONS, then three overlapping boxes at the largest; phase 9's wide
    # grids: 512x1024 (2 images x CFG) with the real_pose layout's boxes,
    # 1024x2048 (1 image x CFG) with the 2x layout's, and
    # regionally_sample.sh's two boxes, which end past the lower edge
    boxes = [box for _, _, box in REGIONS]
    wide1 = layout_boxes(layout_rewrite(read_layout(LAYOUT_1X)), 512, 1024)
    wide2 = layout_boxes(layout_rewrite(read_layout(LAYOUT_2X)), 1024, 2048)
    past = layout_boxes(sample_sh_args()['prompt_rewrite'], 512, 1024)
    cases = [(4, hw, hw, d, boxes, 'REGIONS') for hw, d in
             ((64, 40), (32, 80), (16, 160), (8, 160))]
    cases += [(4, 64, 64, 40, OVERLAP_BOXES, 'overlapping')]
    cases += [(4, gh, gh * 2, d, wide1, LAYOUT_1X.name) for gh, d in
              ((64, 40), (32, 80), (16, 160), (8, 160))]
    cases += [(2, gh, gh * 2, d, wide2, LAYOUT_2X.name) for gh, d in
              ((128, 40), (64, 80), (32, 160), (16, 160))]
    cases += [(2, 64, 128, 40, past, 'regionally_sample.sh, past the edge')]
    for b, gh, gw, d, layout, which in cases:
        h, sk, nr = 8, 77, len(layout)
        q = randn(b, gh * gw, h, d)
        gk, gv = randn(b, sk, h, d), randn(b, sk, h, d)
        rk, rv = randn(nr, b, sk, h, d), randn(nr, b, sk, h, d)
        px = ra.boxes_to_grid(layout, gh, gw)
        args = (q, gk, gv, rk, rv, px, (gh, gw))
        out = ra.region_attention(*args)
        ref = ra.region_attention_plain(*args)   # the bf16 twin
        err, rel = _max_err(out, ref), _flash_err(out, ref)
        fault = min(_flash_err(f, ref) for f in _region_faults(*args))
        ms = cuda_ms(lambda: ra.region_attention(*args))
        pms = cuda_ms(lambda: ra.region_attention_plain(*args))
        # this layout's work: a pixel attends each region it lies in, or
        # the global context when it lies in none
        cnt = sum(ra.box_mask(box, gh, gw, 'cpu') for box in px)
        contexts = torch.clamp(cnt, min=1).sum().item()
        bnd = least_time(nbytes(q, gk, gv, rk, rv, out),
                    attn_flops(b, h, contexts, sk, d, 2), PEAK_BF16)
        print(f'[kernels] region_attn (B,N,H,D)=({b},{gh}x{gw},{h},{d}) '
              f'Sk={sk} R={nr} {which} {px.tolist()}: '
              f'error vs twin {rel:.3e} of max|twin| (bound '
              f'{REGION_BF16_REL}), max_abs_err {err:.3e}; planted fault '
              f'{fault:.3e} (must exceed {REGION_BF16_REL}); kernel {ms:.4f} '
              f'ms, plain {pms:.4f} ms, least {bnd[0]:.4f} ms ({bnd[1]})',
              flush=True)
        check(math.isfinite(rel) and rel <= REGION_BF16_REL,
              'region_attn disagrees')
        check(fault > REGION_BF16_REL,
              f'region_attn bound {REGION_BF16_REL} does not reject the '
              'planted fault')
        res.setdefault('region_attn', row(err, ms, pms, bnd))
    res.update(flash_kernel_checks(dev))
    flash_inference_checks(dev)
    res['gn_apply'] = apply_kernel_checks(dev)
    return res


def flash_inference_checks(dev):
    """K4 (forward only, inference mode) at FLASH_INFERENCE, the shapes the
    int8 serving requests give it, against its twin, with its time, its
    least time and SDPA's."""
    g = torch.Generator(device=dev).manual_seed(11)
    for b, s, h, d in FLASH_INFERENCE:
        q, k, v = (torch.randn(b, s, h, d, generator=g, device=dev)
                   .to(torch.bfloat16) for _ in range(3))
        with torch.inference_mode():
            o, lse = fl.flash_fwd(q, k, v)
            ro, rlse = fl.flash_fwd_plain(q, k, v)
            flash_fwd_designs(q, k, v, ro, rlse,
                              f'inference (B,S,H,D)=({b},{s},{h},{d})')
            rel, err = _flash_err(o, ro), _max_err(o, ro)
            lse_err = _max_err(lse, rlse)
            ms = cuda_ms(lambda: fl.flash_fwd(q, k, v))
            pms = cuda_ms(lambda: fl.flash_fwd_plain(q, k, v))
            bnd = least_time(nbytes(q, k, v, o, lse),
                             attn_flops(b, h, s, s, d, 2), PEAK_BF16)
            lib = sdpa_ms(q, k, v)
        print(f'[kernels] flash_fwd inference (B,S,H,D)=({b},{s},{h},{d}) '
              f'bf16 (the int8 requests\' attn1): error vs twin {rel:.3e} '
              f'of max|twin| (bound {FLASH_BF16_REL}), max_abs_err '
              f'{err:.3e}, lse {lse_err:.3e} (bound {FLASH_LSE_BOUND}); '
              f'kernel {ms:.4f} ms, plain {pms:.4f} ms, least {bnd[0]:.4f} '
              f'ms ({bnd[1]}), SDPA {lib:.4f} ms', flush=True)
        check(math.isfinite(rel) and rel <= FLASH_BF16_REL and
              lse_err <= FLASH_LSE_BOUND, 'flash_fwd disagrees at the int8 '
              'requests\' shapes')


def phase_int8_table(dev, card):
    """The int8 serving modes' dense pool (INT8_DENSE) and resnet convs
    (INT8_CONV): the card's int32 accumulators against exact integer
    products, then the round trip (absmax, quantize, torch._int_mm,
    rescale; for a conv the im2col too) against the bf16 product, both
    from CUDA events, with the least times. Returns the table."""
    g = torch.Generator(device=dev).manual_seed(13)
    bf = torch.bfloat16
    table = []
    for name, m, k, n in INT8_DENSE:
        x = torch.randn(m, k, generator=g, device=dev).to(bf)
        lin = nn.Linear(k, n, bias=False, device=dev, dtype=bf)
        with torch.no_grad():
            lin.weight.copy_(torch.randn(n, k, generator=g, device=dev)
                             / math.sqrt(k))
        quant.quantize_dense(lin)
        w = lin.weight.detach()
        xq, _ = quant.quantize_activation(x, -1)
        acc = quant.int_mm(xq, lin.wq)
        exact = xq[:64].cpu().int() @ lin.wq.cpu().int().t()
        check(torch.equal(acc[:64].cpu(), exact),
              f'int8 {name}: the card\'s accumulators are not exact')
        y = quant.int8_matmul(x, lin.wq, lin.wscale)
        ref = F.linear(x, w)
        rel = ((y.float() - ref.float()).norm() / ref.float().norm()).item()
        t_rt = cuda_ms(lambda: quant.int8_matmul(x, lin.wq, lin.wscale))
        t_mm = cuda_ms(lambda: quant.int_mm(xq, lin.wq))
        t_bf = cuda_ms(lambda: F.linear(x, w))
        flops = 2 * m * k * n
        b_rt = least_time(nbytes(x, lin.wq, lin.wscale) + m * n * 2, flops,
                          PEAK_INT8)
        b_bf = least_time(nbytes(x, w) + m * n * 2, flops, PEAK_BF16)
        table.append({'name': name, 'shape': [m, k, n],
                      'int8_roundtrip_ms': t_rt, 'int_mm_ms': t_mm,
                      'bf16_ms': t_bf, 'int8_bound_ms': b_rt[0],
                      'bf16_bound_ms': b_bf[0], 'rel_l2_vs_bf16': rel})
    for name, (b, c, h, w_) in INT8_CONV:
        x = torch.randn(b, c, h, w_, generator=g, device=dev).to(bf)
        conv = nn.Conv2d(c, c, 3, padding=1, bias=False, device=dev,
                         dtype=bf)
        quant.quantize_conv(conv)
        wt = conv.weight.detach()
        y = quant.int8_conv(x, conv.wq, conv.wscale, 1, 1)
        ref = F.conv2d(x, wt, padding=1)
        rel = ((y.float() - ref.float()).norm() / ref.float().norm()).item()
        t_rt = cuda_ms(lambda: quant.int8_conv(x, conv.wq, conv.wscale, 1,
                                               1))
        t_bf = cuda_ms(lambda: F.conv2d(x, wt, padding=1))
        flops = 2 * b * h * w_ * c * c * 9
        b_rt = least_time(nbytes(x, conv.wq, conv.wscale) + nbytes(x),
                          flops, PEAK_INT8)
        b_bf = least_time(nbytes(x, wt) + nbytes(x), flops, PEAK_BF16)
        table.append({'name': name, 'shape': [b, c, h, w_],
                      'int8_roundtrip_ms': t_rt, 'int_mm_ms': None,
                      'bf16_ms': t_bf, 'int8_bound_ms': b_rt[0],
                      'bf16_bound_ms': b_bf[0], 'rel_l2_vs_bf16': rel})
    for r in table:
        check(r['rel_l2_vs_bf16'] < 2e-2,
              f'int8 {r["name"]}: {r["rel_l2_vs_bf16"]} from bf16')
        print(f'[int8] {r["name"]} {r["shape"]}: round trip '
              f'{r["int8_roundtrip_ms"]:.4f} ms'
              + ('' if r['int_mm_ms'] is None else
                 f' (_int_mm alone {r["int_mm_ms"]:.4f} ms)')
              + f', bf16 {r["bf16_ms"]:.4f} ms; least int8 '
              f'{r["int8_bound_ms"]:.4f} ms, bf16 {r["bf16_bound_ms"]:.4f} '
              f'ms; relative L2 to bf16 {r["rel_l2_vs_bf16"]:.2e}; {card}',
              flush=True)
    return table


def _quant_requests(tag, make_pipe, args, kw, ref, ref_s, want, card):
    """Phases 5q and 6q: the request of phase 5 or 6 in each int8 serving
    mode, on the same modules, twice: the launches of each request (`want`),
    finite images not constant, the seconds beside the bf16 request's, the
    peak memory and the relative L2 difference from the bf16 images."""
    ref = ref.astype(np.float64) / 255.0
    for mode in ('int8', 'int8+conv'):
        t0 = time.perf_counter()
        pipe = make_pipe(mode)
        torch.cuda.synchronize()
        t_quant = time.perf_counter() - t0
        torch.cuda.reset_peak_memory_stats()
        outs, secs, reqs = [], [], []
        for _ in range(2):
            before = ops.launch_counts()
            t0 = time.perf_counter()
            outs.append(pipe(*args, **dict(kw, output_type='np')))
            secs.append(time.perf_counter() - t0)
            reqs.append(_sub(ops.launch_counts(), before))
        peak = torch.cuda.max_memory_allocated()
        out = outs[-1]
        rel = float(np.linalg.norm(out - ref) / np.linalg.norm(ref))
        print(f'[{tag}q] quantize={mode!r}: quantized in {t_quant:.2f} s; '
              f'requests {secs[0]:.3f} s (first) and {secs[1]:.3f} s '
              f'(second) against bf16\'s {ref_s:.3f} s (its second '
              f'request, this call); peak device memory '
              f'{peak / 2 ** 30:.2f} GiB; images against bf16\'s: '
              f'relative L2 {rel:.4e}, largest difference '
              f'{float(np.abs(out - ref).max()):.4f}; launches per request '
              f'{reqs[1]}; {card}', flush=True)
        check(out.shape == ref.shape and all(np.isfinite(o).all()
                                             for o in outs),
              f'{tag}q: {mode} gave {out.shape} or a non-finite image')
        check(all(float(im.max()) > float(im.min()) for im in out),
              f'{tag}q: {mode} gave a constant image')
        check(np.array_equal(outs[0], outs[1]),
              f'{tag}q: {mode}: two runs with the same latents differ')
        check(all(r == {**r, **want} for r in reqs),
              f'{tag}q: {mode}: launches {reqs}, expected {want}')


def apply_kernel_checks(dev):
    """K8 against its twin at the VAE decoder's GroupNorm inputs (2 images,
    NCHW): the mid-block attention's norm (no act) first, then the resnets'
    SiLU norms at 64², 256² and 512², bf16 and fp32; then 4 images (a
    validation batch) in bf16, the attention's norm and the SiLU norms at
    each of the decoder's six shapes, and their launch-weighted sum over a
    decode; planted faults (a and b swapped, the SiLU dropped) must come
    out over the bf16 bound; the backward against autograd of the twin.
    Returns the row of the first shape, with torch.addcmul as its library
    call."""
    g = torch.Generator(device=dev).manual_seed(11)
    first = None
    # the decoder's launch-weighted totals: 4 images at 512x512, 1 image at
    # 1024x2048
    decodes = {4: DECODE_NORMS, 1: DECODE_NORMS_2X}
    val = [((b, *norms[0][0]), 'none', (torch.bfloat16,)) for b, norms in
           decodes.items()] + [((b, *chw), 'silu', (torch.bfloat16,))
                               for b, norms in decodes.items()
                               for chw, _ in norms]
    tot = {b: {'ms': 0.0, 'bound': 0.0} for b in decodes}
    for shape, act, dts in [
            ((2, 512, 64, 64), 'none', (torch.bfloat16, torch.float32)),
            ((2, 512, 64, 64), 'silu', (torch.bfloat16, torch.float32)),
            ((2, 256, 256, 256), 'silu', (torch.bfloat16, torch.float32)),
            ((2, 128, 512, 512), 'silu', (torch.bfloat16, torch.float32))] \
            + val:
        for dt in dts:
            x = torch.randn(shape, generator=g, device=dev).to(dt)
            a = torch.randn(shape[:2], generator=g, device=dev) * 0.3 + 1.0
            b = torch.randn(shape[:2], generator=g, device=dev) * 0.3
            out = gs.scale_bias_act(x, a, b, act)
            ref = gs.scale_bias_act_plain(x, a, b, act)
            top = ref.float().abs().max().item()
            err = (out.float() - ref.float()).abs().max().item()
            faults = [gs.scale_bias_act_plain(x, b, a, act)]
            if act == 'silu':
                faults.append(gs.scale_bias_act_plain(x, a, b, 'none'))
            fault = min((f.float() - ref.float()).abs().max().item() / top
                        for f in faults)
            ms = cuda_ms(lambda: gs.scale_bias_act(x, a, b, act))
            pms = cuda_ms(lambda: gs.scale_bias_act_plain(x, a, b, act))
            bnd = least_time(nbytes(x, a, b, out),
                        (2 if act == 'none' else 6) * x.numel(), PEAK_FP32)
            lib = None
            if act == 'none':
                a4, b4 = (t.to(dt)[:, :, None, None] for t in (a, b))
                lib = cuda_ms(lambda: torch.addcmul(b4, x, a4))
            print(f'[kernels] gn_apply (B,C,H,W)={shape} act={act} '
                  f'{str(dt)[6:]}: max_abs_err {err:.3e}, of max|twin| '
                  f'{err / top:.3e} (bound {APPLY_BOUND[dt]:.3e}); planted '
                  f'fault {fault:.3e}; kernel {ms:.4f} ms, plain {pms:.4f} '
                  f'ms, least {bnd[0]:.4f} ms ({bnd[1]}), addcmul {lib} ms',
                  flush=True)
            check(math.isfinite(err) and err / top <= APPLY_BOUND[dt],
                  'gn_apply disagrees')
            check(dt != torch.bfloat16 or fault > APPLY_BOUND[dt],
                  'gn_apply bound does not reject the planted fault')
            if first is None:
                first = row(err, ms, pms, bnd, lib)
            if shape[0] in decodes and act == 'silu':
                n = dict(decodes[shape[0]])[shape[1:]]
                tot[shape[0]]['ms'] += n * ms
                tot[shape[0]]['bound'] += n * bnd[0]
    for b, t in tot.items():
        print(f'[kernels] gn_apply (SiLU) over one decode of {b} images at '
              f'{decodes[b][-1][0][1]}x{decodes[b][-1][0][2]} (30 launches, '
              f'bf16): {t["ms"]:.4f} ms, least {t["bound"]:.4f} ms '
              f'({t["bound"] / t["ms"]:.1%} of the least time)', flush=True)
    # the backward (plain torch) behind the kernel's forward, fp32
    x = torch.randn((2, 64, 32, 32), generator=g, device=dev)
    a = torch.randn((2, 64), generator=g, device=dev) * 0.3 + 1.0
    b = torch.randn((2, 64), generator=g, device=dev) * 0.3
    w = torch.randn(x.shape, generator=g, device=dev)
    grads = []
    for fn in (gs.scale_bias_act, gs.scale_bias_act_plain):
        ts = [t.clone().requires_grad_() for t in (x, a, b)]
        (fn(*ts, 'silu') * w).sum().backward()
        grads.append([t.grad for t in ts])
    gerr = max(_max_err(p, q) / q.abs().max().item()
               for p, q in zip(*grads))
    print(f'[kernels] gn_apply backward vs autograd of the twin, fp32 '
          f'(2,64,32,32) silu: {gerr:.3e} of max|grad| (bound '
          f'{APPLY_BWD_BOUND})', flush=True)
    check(math.isfinite(gerr) and gerr <= APPLY_BWD_BOUND,
          'gn_apply backward disagrees')
    return first


def attn_designs(d):
    """The bf16 designs of csrc/attn_fwd.cu that take heads d wide: both up
    to D 80 (the lock-step one at its 96-wide tiles), the lock-step one up
    to 160."""
    return ('pingpong', 'lockstep') if d <= fl.PINGPONG_MAX_D else \
        ('lockstep',)


def _max_err(a, b):
    return (a.float() - b.float()).abs().max().item()


def _twin_rows(b, h, s, sk, dev):
    """None when K1's plain twin can hold the whole fp32 score matrix, else
    the query rows it is held on: the first, the middle and the last
    TWIN_ROWS."""
    if b * h * s * sk * 4 <= TWIN_SCORE_BYTES:
        return None
    mid = s // 2 - TWIN_ROWS // 2
    return torch.cat([torch.arange(0, TWIN_ROWS),
                      torch.arange(mid, mid + TWIN_ROWS),
                      torch.arange(s - TWIN_ROWS, s)]).to(dev)


def _attn_faults(q, k, v, kv_len):
    """Planted K1 faults, the twin with keys 64-127 (one 64-key tile) left
    out and, for a ragged kv_len, with the ragged last tile left out and
    with the kv_len mask dropped."""
    def drop(t):
        return torch.cat((t[:, :64], t[:, 128:]), dim=1)
    faults = [fa.attn_fwd_plain(q, drop(k), drop(v),
                                64 + max(kv_len - 128, 0))]
    if kv_len % 64:
        faults.append(fa.attn_fwd_plain(q, k, v, kv_len // 64 * 64))
    if kv_len < k.shape[1]:
        faults.append(fa.attn_fwd_plain(q, k, v))
    return faults


def _region_faults(q, gk, gv, rk, rv, px, hw):
    """Planted K7 faults, on the twin: the largest box's context left out,
    the global context attended inside that box, the box moved down one
    pixel row and, where boxes overlap, the sum over the boxes in place of
    their mean."""
    h, w = hw
    masks = [ra.box_mask(box, h, w, q.device) for box in px]
    big = int(np.argmax([float(m.sum()) for m in masks]))
    keep = [i for i in range(len(px)) if i != big]
    rk_g, rv_g = rk.clone(), rv.clone()
    rk_g[big], rv_g[big] = gk, gv
    moved = px.copy()
    moved[big] += np.asarray([1, 0, 1, 0], moved.dtype)
    plain = ra.region_attention_plain
    faults = [plain(q, gk, gv, rk[keep], rv[keep], px[keep], hw),
              plain(q, gk, gv, rk_g, rv_g, px, hw),
              plain(q, gk, gv, rk, rv, moved, hw)]
    cnt = sum(masks).reshape(1, -1, 1, 1)
    if cnt.max() > 1:
        ref = plain(q, gk, gv, rk, rv, px, hw)
        faults.append((ref.float() * torch.clamp(cnt, min=1)).to(ref.dtype))
    return faults


def _flash_err(got, want):
    """Largest error against the twin: relative to the twin's largest entry
    in bf16 (FLASH_BF16_REL, ATTN_BF16_REL, REGION_BF16_REL), absolute in
    fp32 (FLASH_F32_BOUND)."""
    err = _max_err(got, want)
    if want.dtype == torch.bfloat16:
        return err / want.float().abs().max().item()
    return err


def flash_fwd_designs(q, k, v, ro, rlse, what):
    """K4's forward through every bf16 design that takes the shape (the
    route passed explicitly) against the twin's output and LSE, each
    design's time beside SDPA's."""
    lib = sdpa_ms(q, k, v)
    shipped = fl.launch_route(q, k, v)
    for route in attn_designs(q.shape[3]):
        o, lse = fl.flash_fwd(q, k, v, _route=route)
        rel, lse_err = _flash_err(o, ro), _max_err(lse, rlse)
        ms = cuda_ms(lambda: fl.flash_fwd(q, k, v, _route=route))
        print(f'[kernels] flash_fwd {what} {route}'
              f'{" (shipped)" if route == shipped else ""}: error vs twin '
              f'{rel:.3e} of max|twin| (bound {FLASH_BF16_REL}), lse '
              f'{lse_err:.3e} (bound {FLASH_LSE_BOUND}); kernel {ms:.4f} ms,'
              f' SDPA {lib:.4f} ms', flush=True)
        check(math.isfinite(rel) and rel <= FLASH_BF16_REL and
              lse_err <= FLASH_LSE_BOUND, f'flash_fwd ({route}) disagrees')


def flash_kernel_checks(dev):
    """K4, K5 and K6 against their plain twins at the training path's
    shapes (SD1.5, 512², batch 2: the res-64 and res-32 self-attentions), a
    ragged Sq/Sk and fp32; the fp32 backward also against autograd of the
    plain attention, and a rerun that must be bit-identical. The bound must
    reject a planted fault: the twin's backward without Dvec. Returns
    {name: (max_abs_err, ms, plain_ms)} at the first shape."""
    g = torch.Generator(device=dev).manual_seed(7)
    res = {}
    cases = [((2, 4096, 8, 40), 4096, torch.bfloat16),
             ((2, 1024, 8, 80), 1024, torch.bfloat16),
             ((2, 1000, 8, 40), 1100, torch.bfloat16),
             ((2, 1024, 2, 32), 1100, torch.float32)]
    for (b, sq, h, d), sk, dt in cases:
        def randn(*shape):
            return torch.randn(*shape, generator=g, device=dev).to(dt)
        q, k, v = randn(b, sq, h, d), randn(b, sk, h, d), randn(b, sk, h, d)
        do = randn(b, sq, h, d)
        bf16 = dt == torch.bfloat16
        bound = FLASH_BF16_REL if bf16 else FLASH_F32_BOUND
        lse_bound = FLASH_LSE_BOUND if bf16 else FLASH_F32_BOUND
        o, lse = fl.flash_fwd(q, k, v)
        ro, rlse = fl.flash_fwd_plain(q, k, v)
        if bf16:
            flash_fwd_designs(q, k, v, ro, rlse, f'(B,Sq,H,D)=({b},{sq},'
                              f'{h},{d}) Sk={sk}')
        dvec = fl.flash_dvec(do, o)
        dk, dv = fl.flash_bwd_dkv(q, k, v, do, lse, dvec)
        dq = fl.flash_bwd_dq(q, k, v, do, lse, dvec)
        rq, rk, rv = fl.flash_bwd_plain(q, k, v, do, lse, dvec)
        fq, fk, _ = fl.flash_bwd_plain(q, k, v, do, lse,
                                       torch.zeros_like(dvec))
        errs = {'flash_fwd': _flash_err(o, ro),
                'flash_bwd_dkv': max(_flash_err(dk, rk), _flash_err(dv, rv)),
                'flash_bwd_dq': _flash_err(dq, rq)}
        lse_err = _max_err(lse, rlse)
        fault = {'dk': _flash_err(fk, rk), 'dq': _flash_err(fq, rq)}
        abs_errs = {'flash_fwd': max(_max_err(o, ro), lse_err),
                    'flash_bwd_dkv': max(_max_err(dk, rk), _max_err(dv, rv)),
                    'flash_bwd_dq': _max_err(dq, rq)}
        dk2, dv2 = fl.flash_bwd_dkv(q, k, v, do, lse, dvec)
        dq2 = fl.flash_bwd_dq(q, k, v, do, lse, dvec)
        same = all(torch.equal(a, c) for a, c in
                   ((dk, dk2), (dv, dv2), (dq, dq2)))
        kind = 'of max|twin|' if bf16 else 'absolute'
        line = (f'[kernels] flash (B,Sq,H,D)=({b},{sq},{h},{d}) Sk={sk} '
                f'{str(dt)[6:]}: errors vs twin ({kind}) o '
                f'{errs["flash_fwd"]:.3e}, dk/dv {errs["flash_bwd_dkv"]:.3e}'
                f', dq {errs["flash_bwd_dq"]:.3e} (bound {bound}); lse '
                f'{lse_err:.3e} absolute (bound {lse_bound}); planted fault '
                f'(no Dvec) dk {fault["dk"]:.3e}, dq {fault["dq"]:.3e} (must '
                f'exceed {bound}); max_abs_err '
                + ', '.join(f'{n} {e:.3e}' for n, e in abs_errs.items())
                + f'; rerun bit-identical {same}')
        if not bf16:
            qa, ka, va = (t.clone().requires_grad_() for t in (q, k, v))
            fa.attn_fwd_plain(qa, ka, va).backward(do)
            auto = max(_max_err(dq, qa.grad), _max_err(dk, ka.grad),
                       _max_err(dv, va.grad))
            line += f'; vs autograd of attn_fwd_plain {auto:.3e}'
            check(math.isfinite(auto) and auto <= bound,
                  'flash backward disagrees with autograd')
        times = {
            'flash_fwd': (cuda_ms(lambda: fl.flash_fwd(q, k, v)),
                          cuda_ms(lambda: fl.flash_fwd_plain(q, k, v))),
            'flash_bwd_dkv': (
                cuda_ms(lambda: fl.flash_bwd_dkv(q, k, v, do, lse, dvec)),
                cuda_ms(lambda: fl.flash_bwd_dkv_plain(q, k, v, do, lse,
                                                       dvec))),
            'flash_bwd_dq': (
                cuda_ms(lambda: fl.flash_bwd_dq(q, k, v, do, lse, dvec)),
                cuda_ms(lambda: fl.flash_bwd_dq_plain(q, k, v, do, lse,
                                                      dvec)))}
        line += '; ' + ', '.join(f'{n} {t[0]:.4f} ms (plain {t[1]:.4f})'
                                 for n, t in times.items())
        # the fp32 variants run on the CUDA cores, bf16 on the tensor cores
        peak = PEAK_BF16 if bf16 else PEAK_FP32
        bnds = {'flash_fwd': least_time(nbytes(q, k, v, o, lse),
                                        attn_flops(b, h, sq, sk, d, 2), peak),
                'flash_bwd_dkv': least_time(
                    nbytes(q, k, v, do, lse, dvec, dk, dv),
                    attn_flops(b, h, sq, sk, d, 4), peak),
                'flash_bwd_dq': least_time(
                    nbytes(q, k, v, do, lse, dvec, dq),
                    attn_flops(b, h, sq, sk, d, 3), peak)}
        line += '; least ' + ', '.join(
            f'{n} {t[0]:.4f} ms ({t[1]})' for n, t in bnds.items())
        # SDPA's forward and its backward (dq, dk and dv in one call)
        qa, ka, va = (t.transpose(1, 2).detach().requires_grad_()
                      for t in (q, k, v))
        sdpa_out = F.scaled_dot_product_attention(qa, ka, va)
        do_t = do.transpose(1, 2)
        libs = {'flash_fwd': sdpa_ms(q, k, v)}
        libs['flash_bwd_dkv'] = libs['flash_bwd_dq'] = cuda_ms(
            lambda: torch.autograd.grad(sdpa_out, (qa, ka, va), do_t,
                                        retain_graph=True))
        line += f'; SDPA forward {libs["flash_fwd"]:.4f} ms, SDPA ' \
            f'backward (dq, dk, dv) {libs["flash_bwd_dq"]:.4f} ms'
        if not res:   # the first (main-path) shape
            for name in bnds:
                res[name] = row(abs_errs[name], *times[name], bnds[name],
                                libs[name])
        print(line, flush=True)
        check(same, 'flash backward reruns differ')
        check(math.isfinite(lse_err) and lse_err <= lse_bound,
              'flash_fwd lse disagrees')
        check(all(v > bound for v in fault.values()),
              f'flash bound {bound} does not reject the planted fault')
        for name, err in errs.items():
            check(math.isfinite(err) and err <= bound, f'{name} disagrees')
    return res


def _tiny_pipes(dev, cls, concepts, **extra):
    """The same tiny fp32 pipeline on the card and on the CPU."""
    b = zoo.load_models('random:tiny', 'cpu', seed=0)
    cfg, table = init_concepts(b.tokenizer, concepts, None,
                               b.text_encoder.token_embedding.weight)
    mods = (b.unet, b.text_encoder, b.vae)
    kw = dict(dtype=torch.float32, new_concept_cfg=cfg,
              concept_embedding=table)
    gpu = cls(*copy.deepcopy(mods), b.tokenizer, dev, **kw,
              **copy.deepcopy(extra))
    cpu = cls(*mods, b.tokenizer, 'cpu', **kw, **extra)
    return gpu, cpu


def _wiring_run(name, gpu, cpu, args, kw, expect):
    ops.reset_launch_counts()
    img_gpu = gpu(*args, **kw)
    counts = ops.launch_counts()
    img_cpu = cpu(*args, **kw)
    err = float(np.abs(img_gpu - img_cpu).max())
    print(f'[wiring] {name}: tiny fp32 512x512 2 steps, card vs CPU: '
          f'max_abs_err {err:.3e} (bound {WIRING_BOUND}); launches {counts}',
          flush=True)
    check(img_gpu.shape == img_cpu.shape and img_gpu.shape[1:] ==
          (512, 512, 3), f'wiring: {name} gave {img_gpu.shape}')
    check(all(counts[k] > 0 for k in expect) and
          all(counts[k] == 0 for k in FLASH_KERNELS),
          f'wiring: {name}: unexpected launches: {counts}')
    check(np.isfinite(img_gpu).all() and err <= WIRING_BOUND,
          f'wiring: {name}: card and CPU disagree')


def phase_wiring(dev):
    exact_fp32()
    lat = torch.randn((2, 4, 64, 64),
                      generator=torch.Generator().manual_seed(0))
    kw = dict(height=512, width=512, num_inference_steps=2,
              guidance_scale=7.5, output_type='np')
    gpu, cpu = _tiny_pipes(dev, EDLoRAPipeline, '<c1>+<c2>')
    _wiring_run('edlora', gpu, cpu,
                (['a photo of <c1> at the beach', 'a <c2> in a garden'],),
                dict(kw, latents=lat), PLAIN_PATH_KERNELS)
    gpu, cpu = _tiny_pipes(
        dev, RegionallyT2IAdapterPipeline, '<c1>+<c2>',
        keypose_adapter=zoo.load_t2i_adapter('keypose', 'tiny', 'cpu',
                                             seed=3))
    layout = [('two friends in a park',
               [('a <c1>', 'blurry', [0.0, 0.05, 1.0, 0.5]),
                ('a <c2>', '', [0.1, 0.4, 0.9, 0.95])])]
    _wiring_run('regional', gpu, cpu, (layout,),
                dict(kw, latents=lat[:1], negative_prompt='low quality',
                     keypose_adapter_input=Image.open(POSE).convert('RGB')),
                SAMPLING_KERNELS)


def conv_layouts(tag, unet, evals):
    """`layers.conv2d.layouts` since the last reset, checked: the UNet's
    convs ran `evals` evals on channels-last input (the VAE's and the
    adapter's stay NCHW, 'other')."""
    layouts = dict(layers.conv2d.layouts)
    n = sum(isinstance(m, nn.Conv2d) for m in unet.modules())
    check(layouts.get('channels_last', 0) == n * evals,
          f'{tag}: {layouts} conv calls by input layout, expected '
          f'{n} x {evals} channels-last')
    return layouts


def phase_main(dev, card):
    t0 = time.perf_counter()
    b = zoo.load_models('random:sd15', dev, seed=0, dtype=torch.bfloat16)
    cfg, table = init_concepts(b.tokenizer, '<cat1>+<dog2>', None,
                               b.text_encoder.token_embedding.weight)
    pipe = EDLoRAPipeline(b.unet, b.text_encoder, b.vae, b.tokenizer, dev,
                          torch.bfloat16, new_concept_cfg=cfg,
                          concept_embedding=table)
    torch.cuda.synchronize()
    print(f'[main] SD1.5 bf16 random init on the card: '
          f'{time.perf_counter() - t0:.2f} s', flush=True)
    prompts = ['a photo of <cat1> sitting on a sofa, best quality',
               '<dog2> running on the beach at sunset']
    lat = torch.randn((2, 4, 64, 64), device=dev,
                      generator=torch.Generator(device=dev).manual_seed(1))
    kw = dict(height=512, width=512, num_inference_steps=50,
              guidance_scale=7.5, latents=lat, output_type='uint8')

    ops.reset_launch_counts()
    t0 = time.perf_counter()
    out_call = pipe(prompts, **kw)
    t_call = time.perf_counter() - t0
    t0 = time.perf_counter()
    pending = pipe.submit(prompts, **kw)
    t_queued = time.perf_counter() - t0
    out_submit = pending.result()
    t_submit = time.perf_counter() - t0
    counts = ops.launch_counts()
    layouts = conv_layouts('main', pipe.unet, 2 * 50)

    for name, out in (('__call__', out_call), ('submit', out_submit)):
        check(out.shape == (2, 512, 512, 3) and out.dtype == np.uint8,
              f'main: {name} gave {out.shape} {out.dtype}')
        check(all(int(im.max()) > int(im.min()) for im in out),
              f'main: {name} gave a constant image')
    check(np.array_equal(out_call, out_submit),
          'main: two runs with the same latents differ')
    check(all(counts[k] > 0 for k in PLAIN_PATH_KERNELS) and
          counts['gn_apply'] == counts['gn_spatial_sums'] and
          all(counts[k] == 0 for k in FLASH_KERNELS),
          f'main: unexpected launches: {counts}')
    print(f'[main] 2 prompts 512x512, 50 steps, CFG 7.5: __call__ '
          f'{t_call:.3f} s ({2 / t_call:.4f} img/s, first request), '
          f'submit().result() {t_submit:.3f} s ({2 / t_submit:.4f} img/s; '
          f'submit() returned after {t_queued:.3f} s); {card}; launches '
          f'{counts}; conv calls by input layout {layouts}', flush=True)

    # the same request with an attention store attached
    store = AttentionStore()
    pipe.set_controller(store)
    before = ops.launch_counts()
    t0 = time.perf_counter()
    out_ctl = pipe(prompts, **kw)
    t_ctl = time.perf_counter() - t0
    pipe.set_controller(None)
    after = ops.launch_counts()
    req = {k: after[k] - before[k] for k in after}
    avg = store.get_average_attention()
    maps = [m for key in sorted(avg) for m in avg[key]]
    small = [q for *_, q in cross_layer_query_sizes(pipe.unet.cfg, 64, 64)
             if q <= store.max_size ** 2]
    rowsum = max(float(np.abs(m.sum(-1) - 1.0).max()) for m in maps)
    diff = np.abs(out_ctl.astype(int) - out_call.astype(int))
    same = float((diff == 0).mean())
    print(f'[main] the request with an AttentionStore (max_size '
          f'{store.max_size}): {t_ctl:.3f} s; {len(maps)} maps '
          f'{sorted((m.shape[-2], m.shape[-1]) for m in maps)} over '
          f'{store.cur_step} steps, rows summing to 1 within {rowsum:.2e}; '
          f'images against the first request: {same:.4%} of the values '
          f'identical, largest difference {int(diff.max())} uint8 levels '
          f'(the 77-key cross-attention takes the same dense route with and '
          f'without capture); launches {req}', flush=True)
    check(len(maps) == len(small) == 11 and store.cur_step == 50 and
          sorted(m.shape[-2] for m in maps) == sorted(small) and
          all(m.shape[-1] == 77 for m in maps),
          f'main: the store holds {len(maps)} maps over {store.cur_step} '
          f'steps')
    check(rowsum <= 1e-3, f'main: attention rows sum to 1 within {rowsum}')
    check(int(diff.max()) <= 1, 'main: the request with a controller '
          'differs from the one without by more than one level')
    check(req == {k: v // 2 for k, v in counts.items()},
          f'main: the controller request launched {req}')
    _quant_requests('main', lambda mode: EDLoRAPipeline(
        b.unet, b.text_encoder, b.vae, b.tokenizer, dev, torch.bfloat16,
        new_concept_cfg=cfg, concept_embedding=table, quantize=mode),
        (prompts,), kw, out_call, t_submit, QUANT_REQUEST, card)
    return ops.launch_counts()


def phase_regional(dev, card):
    t0 = time.perf_counter()
    b = zoo.load_models('random:sd15', dev, seed=0, dtype=torch.bfloat16)
    cfg, table = init_concepts(b.tokenizer, CONCEPTS, None,
                               b.text_encoder.token_embedding.weight)
    adapter = zoo.load_t2i_adapter('keypose', 'sd15', dev, seed=3,
                                   dtype=torch.bfloat16)
    pipe = RegionallyT2IAdapterPipeline(
        b.unet, b.text_encoder, b.vae, b.tokenizer, dev, torch.bfloat16,
        new_concept_cfg=cfg, concept_embedding=table,
        keypose_adapter=adapter)
    torch.cuda.synchronize()
    print(f'[regional] SD1.5 bf16 + keypose adapter, random init on the '
          f'card: {time.perf_counter() - t0:.2f} s', flush=True)
    layout = [('three people standing in a park, best quality', REGIONS)]
    lat = torch.randn((2, 4, 64, 64), device=dev,
                      generator=torch.Generator(device=dev).manual_seed(2))
    kw = dict(keypose_adapter_input=Image.open(POSE).convert('RGB'),
              height=512, width=512, num_inference_steps=50,
              guidance_scale=7.5, num_images_per_prompt=2, latents=lat,
              output_type='uint8')

    ops.reset_launch_counts()
    t0 = time.perf_counter()
    out_call = pipe(layout, **kw)
    t_call = time.perf_counter() - t0
    first = ops.launch_counts()
    t0 = time.perf_counter()
    pending = pipe.submit(layout, **kw)
    t_queued = time.perf_counter() - t0
    out_submit = pending.result()
    t_submit = time.perf_counter() - t0
    counts = ops.launch_counts()
    second = {k: counts[k] - first[k] for k in counts}
    layouts = conv_layouts('regional', pipe.unet, 2 * 50)

    for name, out in (('__call__', out_call), ('submit', out_submit)):
        check(out.shape == (2, 512, 512, 3) and out.dtype == np.uint8,
              f'regional: {name} gave {out.shape} {out.dtype}')
        check(all(int(im.max()) > int(im.min()) for im in out),
              f'regional: {name} gave a constant image')
    check(np.array_equal(out_call, out_submit),
          'regional: two runs with the same latents differ')
    for req in (first, second):
        check(req['region_attn'] == 16 * 50 and
              all(req[k] > 0 for k in PLAIN_PATH_KERNELS) and
              req['gn_apply'] == req['gn_spatial_sums'] and
              all(req[k] == 0 for k in FLASH_KERNELS),
              f'regional: launches per request {first}, {second}')
    print(f'[regional] 3 regions, keypose, 2 images 512x512, 50 steps, CFG '
          f'7.5: __call__ {t_call:.3f} s ({2 / t_call:.4f} img/s, first '
          f'request), submit().result() {t_submit:.3f} s ({2 / t_submit:.4f}'
          f' img/s; submit() returned after {t_queued:.3f} s); {card}; '
          f'launches per request {first}, {second}; conv calls by input '
          f'layout {layouts}', flush=True)
    _quant_requests('regional', lambda mode: RegionallyT2IAdapterPipeline(
        b.unet, b.text_encoder, b.vae, b.tokenizer, dev, torch.bfloat16,
        new_concept_cfg=cfg, concept_embedding=table,
        keypose_adapter=adapter, quantize=mode), (layout,), kw, out_call,
        t_submit, {**QUANT_REQUEST, 'region_attn': 16 * 50}, card)
    return ops.launch_counts()


def _concept_batch(trainer, b, img, seed):
    """A tensorized batch as the data pipeline emits it (JAX layout)."""
    rng = np.random.default_rng(seed)
    bound = bind_concept_prompt(['a photo of <c1> <c2> at the beach'] * b,
                                trainer.new_concept_cfg)
    ids = trainer.tokenizer(bound).reshape(b, 16, 77)
    pos = [i for i, t in enumerate(ids[0, 0])
           if t in trainer.concept_token_ids][:2]
    lat = img // 8
    masks = np.ones((b, lat, lat, 1), np.float32)
    masks[:, :lat // 3] = 0
    return {'images': rng.uniform(-1, 1, (b, img, img, 3)).astype(np.float32),
            'text_ids': ids.astype(np.int32), 'masks': masks,
            'img_masks': np.ones((b, lat, lat, 1), np.float32),
            'concept_pos': np.asarray([pos] * b, np.int32),
            'concept_pos_mask': np.ones((b, 2), np.float32)}


def _grad_groups(trainable):
    return {'embedding': [trainable['concept_embedding'].grad],
            'text LoRA': [t.grad for leaf in flatten_lora(
                trainable['text_lora']).values() for t in leaf.values()],
            'UNet LoRA': [t.grad for leaf in flatten_lora(
                trainable['unet_lora']).values() for t in leaf.values()]}


def _encoder_norms(vae):
    return sum(isinstance(m, nn.GroupNorm) for m in vae.encoder.modules())


def phase_wiring_train(dev):
    """One tiny fp32 EDLoRATrainer loss and backward at 512x512 (the tiny
    UNet's res-64 and res-32 self-attentions take the flash route), card vs
    CPU, on the same batch and draws."""
    exact_fp32()
    b = zoo.load_models('random:tiny', 'cpu', seed=0)
    mods = (b.unet, b.text_encoder, b.vae)
    m = yaml.safe_load(TRAIN_YML.read_text())['models']
    kw = dict(new_concept_token='<c1>+<c2>',
              initializer_token='<rand-0.013>+<rand-0.017>',
              finetune_cfg=m['finetune_cfg'], noise_offset=m['noise_offset'],
              attn_reg_weight=m['attn_reg_weight'],
              reg_full_identity=m['reg_full_identity'],
              compute_dtype=torch.float32)
    gpu = EDLoRATrainer(*copy.deepcopy(mods), CLIPTokenizer(), dev, **kw)
    cpu = EDLoRATrainer(*mods, CLIPTokenizer(), 'cpu', **kw)
    opt = train_edlora.make_optimizer(m['finetune_cfg'], 10)
    batch = _concept_batch(cpu, 2, 512, seed=0)
    draws = cpu.make_draws(2, (64, 64), torch.Generator().manual_seed(0))
    res = []
    for trainer in (gpu, cpu):
        state = trainer.init_state(opt)
        with torch.no_grad():   # non-zero ups: every LoRA leaf gets a grad
            for leaf in flatten_lora(state.trainable['unet_lora']).values():
                leaf['up'].fill_(0.01)
        ops.reset_launch_counts()
        loss, ld = trainer.loss_fn(state.trainable, batch, draws=draws)
        loss.backward()
        res.append((loss.item(), ld, _grad_groups(state.trainable),
                    ops.launch_counts()))
    (gl, gld, gg, counts), (cl, cld, cg, _) = res
    errs = {'loss': abs(gl - cl) / abs(cl),
            'attn_reg': abs(gld['loss_attn_reg'].item() -
                            cld['loss_attn_reg'].item()) /
            abs(cld['loss_attn_reg'].item())}
    for name in gg:
        scale = max(t.abs().max().item() for t in cg[name])
        errs[name] = max((a.cpu() - c).abs().max().item()
                         for a, c in zip(gg[name], cg[name])) / scale
        check(scale > 0, f'wiring train: no {name} gradient on the CPU')
    print(f'[wiring] train step: tiny fp32 512x512 b2, card vs CPU: loss '
          f'{gl:.6f} vs {cl:.6f}; relative errors '
          + ', '.join(f'{k} {v:.3e}' for k, v in errs.items())
          + f' (bound {WIRING_TRAIN_BOUND}); launches {counts}', flush=True)
    check(all(math.isfinite(v) and v <= WIRING_TRAIN_BOUND
              for v in errs.values()), 'wiring train: card and CPU disagree')
    want = _step_launches(gpu)
    check(counts == want, f'wiring train: launches {counts}, expected {want}')


def _seeded_delta(path, names, seed, unet, text_encoder):
    """A concept delta like a trained one, from a seed: rank-4 LoRA on the
    reference finetune_cfg's layers (text q/k/v/out, UNet attn1 and attn2
    q/k/v/out) with up ~ N(0, 0.01), and <rand-0.013> rows for each token.
    `unet` and `text_encoder` give only shapes (meta modules will do)."""
    rng = np.random.default_rng(seed)
    tl = init_lora_tree(rng, text_encoder, lambda p: '/attn/' in p)
    ul = init_lora_tree(rng, unet, lambda p: '/attn1/' in p or '/attn2/' in p)
    for leaf in [*flatten_lora(tl).values(), *flatten_lora(ul).values()]:
        leaf['up'] = torch.from_numpy(rng.normal(
            0, 0.01, tuple(leaf['up'].shape)).astype(np.float32))
    width = text_encoder.cfg.width
    emb = {n: torch.from_numpy((0.013 * rng.normal(size=(16, width)))
                               .astype(np.float32)) for n in names}
    save_edlora_delta(str(path), {'new_concept_embedding': emb,
                                  'text_lora': tl, 'unet_lora': ul})


def _concept_entry(path, names):
    return {'lora_path': str(path), 'unet_alpha': 1.0,
            'text_encoder_alpha': 1.0, 'concept_name': ' '.join(names)}


def phase_wiring_fusion(dev):
    """Two tiny concepts fused through compose_concepts in fp32 (TF32 off)
    at 2 spatial steps and 64x64, on the card and on the CPU, from the same
    weights, deltas and latents (the CPU's draws); every solved kernel of
    the three phases compared."""
    exact_fp32()
    root = Path(tempfile.mkdtemp(prefix='mos_chip_fuse_tiny_'))
    try:
        b = zoo.load_models('random:tiny', 'cpu', seed=0)
        cfg = []
        for i, names in enumerate((['<c1>', '<c2>'], ['<d1>', '<d2>'])):
            _seeded_delta(root / f'{i}.pth', names, 100 + i, b.unet,
                          b.text_encoder)
            cfg.append(_concept_entry(root / f'{i}.pth', names))
        (root / 'concepts.json').write_text(json.dumps(cfg))
        lat = [torch.randn((1, 4, 8, 8),
                           generator=torch.Generator().manual_seed(ci))
               for ci in range(2)]
        reports, counts = {}, None
        for name, d in (('card', dev), ('cpu', torch.device('cpu'))):
            mods = copy.deepcopy((b.unet, b.text_encoder, b.vae))
            bundle = zoo.ModelBundle(*(m.to(d) for m in mods),
                                     CLIPTokenizer())
            reports[name] = {}
            ops.reset_launch_counts()
            compose_concepts(str(root / 'concepts.json'), None,
                             str(root / name), d, spatial_steps=2,
                             image_size=64, bundle=bundle,
                             compute_dtype=torch.float32, latents=lat,
                             report=reports[name])
            counts = counts or ops.launch_counts()
        errs, entries, sizes = {}, {}, {}
        for phase, module in (('text', b.text_encoder), ('crosskv', b.unet),
                              ('spatial', b.unet)):
            cpu, card = reports['cpu'][phase], reports['card'][phase]
            check(set(cpu['kernels']) == set(card['kernels']),
                  f'wiring fusion: {phase} solved other layers')
            sizes[phase] = len(cpu['kernels'])
            w0 = {p: layer_kernel(module, p) for p in cpu['kernels']}
            errs[phase] = max(output_difference(
                card['kernels'][p].cpu(), w, w0[p], cpu['grams'][p])
                for p, w in cpu['kernels'].items())
            entries[phase] = max(
                (card['kernels'][p].cpu() - w).abs().max().item() /
                (w - w0[p]).abs().max().item()
                for p, w in cpu['kernels'].items())
    finally:
        shutil.rmtree(root, ignore_errors=True)
    print(f'[wiring] fusion: tiny fp32 2 concepts, 2 spatial steps 64x64, '
          f'card vs CPU: layers {sizes}; largest output difference '
          + ', '.join(f'{k} {v:.3e}' for k, v in errs.items())
          + f' (bound {WIRING_FUSION_BOUND}); largest kernel entry '
          'difference of max|ΔW| '
          + ', '.join(f'{k} {v:.3e}' for k, v in entries.items())
          + f'; card seconds {reports["card"]["seconds"]}; launches '
          f'{counts}', flush=True)
    check(sizes == {'text': 8, 'crosskv': 32, 'spatial': 96},
          f'wiring fusion: layers {sizes}')
    check(all(math.isfinite(v) and v <= WIRING_FUSION_BOUND
              for v in errs.values()), 'wiring fusion: card and CPU disagree')


def _write_concept(root: Path, seed: int = 0):
    """4 seeded synthetic 640x512 images with captions and masks, the
    concept list, and TRAIN_YML pointed at them with phase 7's cuts (the
    length, saves every SAVE_FREQ steps, VAL_SAMPLES samples a validation
    prompt); returns the YAML's path."""
    rng = np.random.default_rng(seed)
    dirs = {n: root / n for n in ('img', 'mask', 'caption')}
    for d in dirs.values():
        d.mkdir(parents=True)
    yy, xx = np.mgrid[0:640, 0:512]
    for i in range(4):
        base = rng.uniform(0, 255, (1, 1, 3))
        img = base + 40 * np.sin(xx[..., None] / (17 + 5 * i)
                                 + yy[..., None] / 23 + rng.uniform(0, 6, 3))
        img += rng.normal(0, 12, img.shape)
        Image.fromarray(np.clip(img, 0, 255).astype(np.uint8)).save(
            dirs['img'] / f'{i}.png')
        m = np.zeros((640, 512), np.uint8)
        m[100 + 20 * i:560, 96:416 - 10 * i] = 255
        Image.fromarray(m).save(dirs['mask'] / f'{i}.png')
        (dirs['caption'] / f'{i}.txt').write_text(
            f'<TOK>, a person in a red coat, photo {i}\n')
    concept = root / 'concept.json'
    concept.write_text(json.dumps([{
        'instance_prompt': '<TOK>', 'instance_data_dir': str(dirs['img']),
        'caption_dir': str(dirs['caption']), 'mask_dir': str(dirs['mask'])}]))
    opt = yaml.safe_load(TRAIN_YML.read_text())
    check(opt['val']['val_during_save'] is True,
          f'{TRAIN_YML.name} no longer validates during saves')
    opt['manual_seed'] = seed
    train = opt['datasets']['train']
    train['concept_list'] = str(concept)
    train['dataset_enlarge_ratio'] = TRAIN_STEPS * \
        train['batch_size_per_gpu'] // 4
    val = opt['datasets']['val_vis']
    val['prompts'] = str(ROOT / val['prompts'])
    val['num_samples_per_prompt'] = VAL_SAMPLES
    opt['models']['pretrained_path'] = 'random:sd15'
    opt['path'] = {'experiments_root': str(root / 'experiment')}
    opt['logger'] = {'print_freq': 1, 'save_checkpoint_freq': SAVE_FREQ}
    path = root / 'edlora_sd15.yml'
    path.write_text(yaml.safe_dump(opt))
    return path


class _LogLines(logging.Handler):
    """The port's log messages, and the learning rates of its iteration
    lines by step."""

    def __init__(self):
        super().__init__()
        self.lines = []
        self.logger = logging.getLogger('mixofshow_tpu_torch')

    def emit(self, record):
        self.lines.append(record.getMessage())

    def __enter__(self):
        self.logger.addHandler(self)
        return self

    def __exit__(self, *exc):
        self.logger.removeHandler(self)

    def lrs(self):
        out = {}
        for line in self.lines:
            m = re.search(r'Iter:\s*([\d,]+), lr:\(([^)]*)\)', line)
            if m:
                out[int(m.group(1).replace(',', ''))] = m.group(2)
        return out


def _run_train(argv, dev, report=None):
    """train_edlora.main with a mark (step, host time, launch counts, loss)
    at each on_step call; returns (trainer, state, marks, peak device
    memory from the first mark, the log's learning rates)."""
    marks = []

    def on_step(step, loss_dict):
        torch.cuda.synchronize()
        marks.append((step, time.perf_counter(), ops.launch_counts(),
                      {k: float(v) for k, v in loss_dict.items()}))
        if len(marks) == 1:
            torch.cuda.reset_peak_memory_stats()

    with _LogLines() as log:
        trainer, state, _ = train_edlora.main(
            argv + ['--device', str(dev)], on_step=on_step, report=report)
    torch.cuda.synchronize()
    marks.append(('end', time.perf_counter(), ops.launch_counts(), {}))
    return trainer, state, marks, torch.cuda.max_memory_allocated(), \
        log.lrs()


def _step_launches(trainer):
    """A train step's launches: 10 of each flash kernel, one K3, the VAE
    encoder's K2 and K8 counts, no K1."""
    enc_norms = _encoder_norms(trainer.vae)
    return {'flash_fwd': 10, 'flash_bwd_dkv': 10, 'flash_bwd_dq': 10,
            'attn_fwd': 0, 'attn_block': 1, 'region_attn': 0,
            'gn_spatial_sums': enc_norms, 'gn_apply': enc_norms}


def _sub(a, b, times=1):
    return {k: a[k] - times * b.get(k, 0) for k in a}


def _check_pngs(vis_dir, tags, alphas, n):
    """Each `<tag>Alpha-<alpha>` directory holds n PNGs and has its grid."""
    for tag in tags:
        for alpha in alphas:
            d = vis_dir / f'{tag}Alpha-{alpha}'
            pngs = sorted(p.name for p in d.glob('*.png'))
            check(len(pngs) == n and
                  (vis_dir / f'{d.name}---composed.jpg').exists(),
                  f'{d}: {len(pngs)} PNGs, grid '
                  f'{(vis_dir / f"{d.name}---composed.jpg").exists()}')


def phase_train(dev, card, root, delta_path):
    """Phase 7 in `root` (kept for the resume and test_edlora phases); the
    run's last delta is copied to `delta_path`. Returns the launches and
    what the next phases compare with."""
    yml = _write_concept(root)
    opt = yaml.safe_load(yml.read_text())
    alphas = opt['val']['alpha_list']
    prompts = len(PromptDataset(opt['datasets']['val_vis']))
    per_sweep = len(alphas) * math.ceil(
        prompts / opt['datasets']['val_vis']['batch_size_per_gpu'])
    ops.reset_launch_counts()
    report = {}
    t0 = time.perf_counter()
    trainer, state, marks, peak, lrs = _run_train(['-opt', str(yml)], dev,
                                                  report)
    t_total = time.perf_counter() - t0
    steps = [m[0] for m in marks[:-1]]
    check(steps == list(range(TRAIN_STEPS + 1)), f'train: steps {steps}')
    want = _step_launches(trainer)
    saves = [s['tag'] for s in report['saves']]
    check(saves == [SAVE_FREQ * i for i in range(1, TRAIN_STEPS //
                                                   SAVE_FREQ + 1)]
          + ['latest'], f'train: saves {saves}')
    step_s, sweeps = [], []
    # a save at step k (after the mark of k) lands in the interval to k+1;
    # the saves at the last step and 'latest' after the last mark
    for prev, cur in zip(marks, marks[1:]):
        per = _sub(cur[2], prev[2])
        n_sweeps = 1 + (TRAIN_STEPS % SAVE_FREQ == 0) if cur[0] == 'end' \
            else int(prev[0] > 0 and prev[0] % SAVE_FREQ == 0)
        train_part = _sub(per, VAL_REQUEST, per_sweep * n_sweeps)
        if cur[0] != 'end':
            check(train_part == {**train_part, **want},
                  f'train: step {cur[0]} launches {per}, expected {want} '
                  f'and {n_sweeps} sweeps of {per_sweep} x {VAL_REQUEST}')
            check(all(math.isfinite(v) for v in cur[3].values()),
                  f'train: step {cur[0]} loss {cur[3]}')
            if n_sweeps == 0 and cur[0] > 1:
                step_s.append(cur[1] - prev[1])
        else:
            check(all(v == 0 for v in train_part.values()),
                  f'train: launches after the last step {per}, expected '
                  f'{n_sweeps} sweeps of {per_sweep} x {VAL_REQUEST}')
        sweeps.append(n_sweeps)
    check(sum(sweeps) == len(saves), f'train: sweeps {sweeps}')
    first_step = marks[1][1] - marks[0][1]

    # every trainable group moved, every attn1 LoRA leaf included
    init, now = trainer.trainable_init, state.trainable
    moved = {'embedding': (now['concept_embedding'] -
                           init['concept_embedding']).abs().max().item()}
    for key, name in (('text_lora', 'text LoRA'),
                      ('unet_lora', 'UNet LoRA')):
        a, b = flatten_lora(init[key]), flatten_lora(now[key])
        moved[name] = min((b[p][n] - a[p][n]).abs().max().item()
                          for p in a for n in ('down', 'up'))
    attn1 = [p for p in flatten_lora(now['unet_lora']) if '/attn1/' in p]
    moved['attn1 leaves'] = min(
        (flatten_lora(now['unet_lora'])[p][n] -
         flatten_lora(init['unet_lora'])[p][n]).abs().max().item()
        for p in attn1 for n in ('down', 'up'))
    check(len(attn1) == 64 and all(v > 0 for v in moved.values()),
          f'train: a trainable group did not move: {moved}')

    # the saves: deltas with the reference keys, train states, the sweeps'
    # PNGs and grids
    exp = root / 'experiment'
    models = exp / 'models'
    saved = sorted(os.listdir(models))
    tags = [str(t) for t in saves]
    check(saved == sorted([f'edlora_model-{t}.pth' for t in tags] +
                          [f'train_state-{t}.pt' for t in tags]),
          f'train: saved {saved}')
    delta = torch.load(models / 'edlora_model-latest.pth',
                       map_location='cpu', weights_only=True)['params']
    te, un = delta['text_encoder'], delta['unet']
    key_q = ('down_blocks.0.attentions.0.transformer_blocks.0.attn1.'
             'to_q.lora_up.weight')
    tokens = sorted(trainer.new_concept_cfg)
    check(set(delta['new_concept_embedding']) == set(tokens)
          and delta['new_concept_embedding'][tokens[0]].shape == (16, 768)
          and len(te) == 12 * 4 * 2 and len(un) == 16 * 8 * 2
          and 'text_model.encoder.layers.11.self_attn.out_proj.'
              'lora_down.weight' in te
          and torch.equal(un[key_q], flatten_lora(now['unet_lora'])[
              'down_blocks/0/attentions/0/attn1/to_q']['up'].detach().cpu()),
          f'train: saved delta with {len(te)} text and {len(un)} UNet keys')
    _check_pngs(exp / 'visualization', [f'Iters-{t}_' for t in tags],
                alphas, prompts)
    shutil.copy(models / 'edlora_model-latest.pth', delta_path)

    steady = sum(step_s) / len(step_s)
    losses = [round(m[3]['loss'], 5) for m in marks[1:-1]]
    val_s = [round(s['validation_s'], 3) for s in report['saves']]
    print(f'[train] SD1.5 ED-LoRA through train_edlora.main, bf16, batch 2, '
          f'512x512, {TRAIN_STEPS} steps, saves at {saves} each validating '
          f'{len(alphas)} alphas x {prompts} prompts (cut: '
          f'num_samples_per_prompt {VAL_SAMPLES}) x '
          f'{opt["val"]["sample"]["num_inference_steps"]} steps, CFG '
          f'{opt["val"]["sample"]["guidance_scale"]}, '
          f'{per_sweep} requests a sweep: first step {first_step:.3f} s, '
          f'steady {steady:.4f} s/step over the steps without a save '
          f'({1 / steady:.3f} steps/s; steps '
          + ', '.join(f'{t:.3f}' for t in step_s) + ' s); validation sweeps '
          f'{val_s} s ({[round(v / per_sweep, 3) for v in val_s]} s a '
          f'request of 4 prompts), saves '
          f'{[round(s["save_s"], 3) for s in report["saves"]]} s; whole run '
          f'{t_total:.2f} s; peak device memory {peak / 2 ** 30:.2f} GiB '
          f'(max_memory_allocated from the first step on, validation '
          f'included); losses {losses}; smallest change {moved}; launches '
          f'per step {want}, per validation request {VAL_REQUEST}; saved '
          f'{saved}; {card}', flush=True)
    total = _sub(marks[-1][2], marks[0][2])
    return total, {'lrs': lrs, 'final_lrs': state.lr_schedule.get_last_lr(),
                   'want': want, 'alphas': alphas, 'prompts': prompts,
                   'per_sweep': per_sweep}


def phase_resume(dev, card, root, phase7):
    """Phase 7's run again from its train_state-3.pt, with validation off:
    the relaunch archives phase 7's experiment and the CLI follows the
    checkpoint there. The loaded state must equal the file bitwise, the
    steps be 4 to 6 with phase 7's launches and logged learning rates."""
    opt = yaml.safe_load((root / 'edlora_sd15.yml').read_text())
    opt['val']['val_during_save'] = False
    yml = root / 'edlora_sd15_resume.yml'
    yml.write_text(yaml.safe_dump(opt))
    ckpt = root / 'experiment' / 'models' / f'train_state-{SAVE_FREQ}.pt'
    ops.reset_launch_counts()
    report = {}
    t0 = time.perf_counter()
    _, state, marks, peak, lrs = _run_train(
        ['-opt', str(yml), '--resume', str(ckpt)], dev, report)
    t_total = time.perf_counter() - t0
    archived = sorted(root.glob('experiment_archived_*'))
    check(len(archived) == 1, f'resume: archived roots {archived}')
    saved = torch.load(archived[0] / 'models' / ckpt.name,
                       map_location='cpu', weights_only=True)
    _same_state(report['resumed'], saved)
    steps = [m[0] for m in marks[:-1]]
    check(steps == list(range(SAVE_FREQ, TRAIN_STEPS + 1)),
          f'resume: steps {steps}')
    for prev, cur in zip(marks, marks[1:-1]):
        per = _sub(cur[2], prev[2])
        check(per == {**per, **phase7['want']},
              f'resume: step {cur[0]} launches {per}')
        check(all(math.isfinite(v) for v in cur[3].values()),
              f'resume: step {cur[0]} loss {cur[3]}')
    resumed_steps = list(range(SAVE_FREQ + 1, TRAIN_STEPS + 1))
    check(sorted(lrs) == resumed_steps and
          all(lrs[s] == phase7['lrs'][s] for s in resumed_steps),
          f'resume: logged learning rates {lrs}, phase 7 {phase7["lrs"]}')
    final = state.lr_schedule.get_last_lr()
    check(final == phase7['final_lrs'] and state.step == TRAIN_STEPS,
          f'resume: final learning rates {final} at micro-step {state.step}'
          f', phase 7 {phase7["final_lrs"]}')
    step_s = [cur[1] - prev[1] for prev, cur in zip(marks, marks[1:-1])]
    losses = [round(m[3]['loss'], 5) for m in marks[1:-1]]
    print(f'[resume] train_edlora.main --resume {ckpt.name} (followed into '
          f'{archived[0].name}), validation off: the loaded state equals '
          f'the file bitwise (trainables, AdamW moments and step, schedule, '
          f'emb_frozen {bool(saved["emb_frozen"])}, step {saved["step"]}); '
          f'steps {steps[1:]} at '
          + ', '.join(f'{t:.3f}' for t in step_s) + f' s, losses {losses}, '
          f'logged learning rates as phase 7\'s ({lrs[resumed_steps[0]]} '
          f'at step {resumed_steps[0]}); whole run {t_total:.2f} s; peak '
          f'device memory {peak / 2 ** 30:.2f} GiB; {card}', flush=True)
    return _sub(marks[-1][2], marks[0][2]), archived[0]


def _same_state(got, want, path='resume: state'):
    """Bitwise equality of two train_state_dict (or delta) payloads."""
    if torch.is_tensor(want):
        check(torch.is_tensor(got) and got.dtype == want.dtype and
              torch.equal(got, want), f'{path} differs')
    elif isinstance(want, dict):
        check(isinstance(got, dict) and got.keys() == want.keys(),
              f'{path} keys differ')
        for k in want:
            _same_state(got[k], want[k], f'{path}/{k}')
    elif isinstance(want, (list, tuple)):
        check(len(got) == len(want), f'{path} length differs')
        for i, (a, b) in enumerate(zip(got, want)):
            _same_state(a, b, f'{path}/{i}')
    else:
        check(got == want, f'{path} {got} != {want}')


def _logged_losses(log_dir):
    """{step: the loss part of its iteration line} from a run's log file."""
    text = next(Path(log_dir).glob('train_*.log')).read_text()
    out = {}
    for m in re.finditer(r'Iter:\s*([\d,]+), lr:\([^)]*\)\] '
                         r'(?:\[eta: [^\]]*\] )?(.*)$', text, re.M):
        # the first run's line: later in-process runs log to the same file
        out.setdefault(int(m.group(1).replace(',', '')), m.group(2).strip())
    return out


def phase_ddp(card, root, archived):
    """Phase 7d: phase 7's run through torchrun at world 1, as a user
    launches it, validation off: the process group must be NCCL, the train
    states and deltas at every save bitwise phase 7's (archived by 7b),
    the logged losses phase 7's."""
    opt = yaml.safe_load((root / 'edlora_sd15.yml').read_text())
    opt['val']['val_during_save'] = False
    opt['path'] = {'experiments_root': str(root / 'experiment_ddp')}
    yml = root / 'edlora_sd15_ddp.yml'
    yml.write_text(yaml.safe_dump(opt))
    torch.cuda.empty_cache()
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT)] + os.environ.get('PYTHONPATH', '').split(os.pathsep)))
    argv = [sys.executable, '-m', 'torch.distributed.run', '--standalone',
            '--nproc_per_node', '1', '-m', 'mixofshow_tpu_torch.train_edlora',
            '-opt', str(yml), '--device', 'cuda']
    t0 = time.perf_counter()
    proc = subprocess.Popen(argv, cwd=ROOT, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True,
                            start_new_session=True)
    try:
        out, _ = proc.communicate(timeout=600)
    finally:
        if proc.poll() is None:
            os.killpg(proc.pid, 9)
            proc.wait()
    t_run = time.perf_counter() - t0
    check(proc.returncode == 0, f'ddp: torchrun exited {proc.returncode}: '
          f'{out[-4000:]}')
    exp = root / 'experiment_ddp'
    log = next(exp.glob('train_*.log')).read_text()
    check('data parallel: 1 process(es), process group nccl' in log,
          'ddp: the run did not join an NCCL process group of one')
    saved = sorted(os.listdir(exp / 'models'))
    check(saved == sorted(os.listdir(archived / 'models')),
          f'ddp: saved {saved}')
    for name in saved:
        _same_state(torch.load(exp / 'models' / name, map_location='cpu',
                               weights_only=True),
                    torch.load(archived / 'models' / name,
                               map_location='cpu', weights_only=True),
                    f'ddp: {name}')
    losses, want = _logged_losses(exp), _logged_losses(archived)
    check(sorted(losses) == list(range(1, TRAIN_STEPS + 1)) and
          losses == want, f'ddp: logged losses {losses}, phase 7 {want}')
    print(f'[ddp] python -m torch.distributed.run --standalone '
          f'--nproc_per_node 1 -m mixofshow_tpu_torch.train_edlora (phase '
          f'7\'s config, validation off): process group nccl, world 1; '
          f'{TRAIN_STEPS} steps in {t_run:.2f} s with the process start, '
          f'the model load and the saves; {saved} bitwise equal to phase '
          f'7\'s; logged losses equal at steps {sorted(losses)} '
          f'({losses[TRAIN_STEPS]} at the last); {card}', flush=True)


def _pngs(d):
    return {p.name: np.asarray(Image.open(p)) for p in sorted(d.glob('*.png'))}


def phase_test_edlora(dev, card, root, delta_path, archived, phase7):
    """The alpha sweep through test_edlora.main on phase 7's last delta
    with the repository's test config; alpha 0 against a pipeline without
    LoRA, alpha 1.0 against phase 7's last validation at alpha 1.0."""
    opt = yaml.safe_load(TEST_YML.read_text())
    train_seed = yaml.safe_load(TRAIN_YML.read_text())['manual_seed']
    check(opt['manual_seed'] == train_seed, 'test_edlora: another seed')
    val = opt['datasets']['val_vis']
    val['prompts'] = str(ROOT / val['prompts'])
    val['num_samples_per_prompt'] = VAL_SAMPLES
    opt['models']['pretrained_path'] = 'random:sd15'
    opt['path'] = {'lora_path': str(delta_path),
                   'experiments_root': str(root / 'test_results')}
    yml = root / 'edlora_sd15_test.yml'
    yml.write_text(yaml.safe_dump(opt))
    alphas = opt['val']['alpha_list']
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    out = test_edlora.main(['-opt', str(yml), '--device', str(dev)])
    t_sweep = time.perf_counter() - t0
    counts = ops.launch_counts()
    n_req = len(alphas) * math.ceil(phase7['prompts'] /
                                    val['batch_size_per_gpu'])
    check(counts == {k: n_req * VAL_REQUEST.get(k, 0) for k in counts},
          f'test_edlora: launches {counts}, expected {n_req} x '
          f'{VAL_REQUEST}')
    vis_dir = root / 'test_results' / 'visualization'
    check(sorted(out) == sorted(alphas), f'test_edlora: outputs {out}')
    _check_pngs(vis_dir, [''], alphas, phase7['prompts'])

    # alpha 0 against the same concept table and latents without LoRA
    dtype = resolve_compute_dtype(opt)
    b = zoo.load_models('random:sd15', dev, seed=train_seed, dtype=dtype)
    cfg, _ = init_concepts(b.tokenizer, opt['models']['new_concept_token'],
                           None, b.text_encoder.token_embedding.weight)
    delta = convert_edlora_delta(load_edlora_delta(str(delta_path)))
    table = torch.cat([delta['new_concept_embedding'][n] for n in cfg])
    pipe = EDLoRAPipeline(b.unet, b.text_encoder, b.vae, b.tokenizer, dev,
                          dtype, new_concept_cfg=cfg, concept_embedding=table)
    visual_validation(pipe, PromptDataset(val), 'no_lora',
                      {**opt, 'path': {'visualization': str(root)}})
    del b, pipe
    zero, none = _pngs(vis_dir / f'Alpha-{alphas[0]}'), _pngs(root /
                                                              'no_lora')
    check(alphas[0] == 0 and list(zero) == list(none) and
          all(np.array_equal(zero[f], none[f]) for f in zero),
          'test_edlora: alpha 0 differs from the pipeline without LoRA')
    # alpha 1.0 against phase 7's validation of the same delta
    one = _pngs(vis_dir / 'Alpha-1.0')
    ref = _pngs(archived / 'visualization' / 'Iters-latest_Alpha-1.0')
    check(list(one) == list(ref), 'test_edlora: other file names than '
          'phase 7\'s')
    diff = [np.abs(one[f].astype(int) - ref[f].astype(int)) for f in one]
    worst = max(int(d.max()) for d in diff)
    same = sum(int((d == 0).sum()) for d in diff) / sum(d.size for d in diff)
    print(f'[test_edlora] test_edlora.main on phase 7\'s last delta with '
          f'{TEST_YML.name} (random:sd15 at seed {train_seed}; cut: '
          f'num_samples_per_prompt {VAL_SAMPLES}), {len(alphas)} alphas x '
          f'{phase7["prompts"]} prompts x '
          f'{opt["val"]["sample"]["num_inference_steps"]} steps, CFG '
          f'{opt["val"]["sample"]["guidance_scale"]}, {n_req} '
          f'requests of 4 prompts: {t_sweep:.2f} s with the model load '
          f'({t_sweep / n_req:.3f} s a request); alpha 0 bit-identical to '
          f'the pipeline without LoRA; alpha 1.0 against phase 7\'s '
          f'Iters-latest_Alpha-1.0: largest difference {worst} uint8 levels '
          f'(bound 1), {same:.4%} of the values identical; launches '
          f'{counts}; {card}', flush=True)
    check(worst <= 1, 'test_edlora: alpha 1.0 differs from phase 7\'s '
          'validation by more than one level')
    return counts


def _lora_paths(delta_path):
    d = convert_edlora_delta(load_edlora_delta(str(delta_path)))
    return {'text_encoder': set(flatten_lora(d['text_lora'])),
            'unet': set(flatten_lora(d['unet_lora']))}


def phase_fusion(dev, card, hermione, root):
    """Phase 8: fuse three concepts at SD1.5 width through the CLI into
    `root`, reload the checkpoint and sample one regional request from it.
    Returns the launches and the fused directory (kept for phase 9)."""
    root.mkdir(parents=True)
    shapes = (UNet(UNetConfig.sd15(), 'meta'),
              CLIPTextModel(CLIPTextConfig.sd15(), 'meta'))
    cfg, leaves = [], {'text_encoder': set(), 'unet': set()}
    for name, seed in (('potter', 1), ('hermione', None), ('thanos', 3)):
        names = [f'<{name}1>', f'<{name}2>']
        path = hermione if seed is None else root / f'{name}.pth'
        if seed is not None:
            _seeded_delta(path, names, seed, *shapes)
        cfg.append(_concept_entry(path, names))
        for k, v in _lora_paths(path).items():
            leaves[k] |= v
    (root / 'concepts.json').write_text(json.dumps(cfg))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    report = {}
    ckpt, new_cfg = gradient_fusion.main(
        ['--concept_cfg', str(root / 'concepts.json'), '--save_path',
         str(root / 'out'), '--pretrained_models', 'random:sd15',
         '--spatial_steps', str(FUSION_STEPS), '--image_size', '512',
         '--device', str(dev)], report=report)
    counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    evals = len(cfg) * FUSION_STEPS
    want = {k: 0 for k in counts}
    want['flash_fwd'] = 10 * evals
    layers = {k: len(report[k]['kernels'])
              for k in ('text', 'crosskv', 'spatial')}
    finite = all(math.isfinite(r) for k in layers
                 for r in report[k]['residuals'].values())
    check(counts == want, f'fusion: launches {counts}, expected {want}')
    check(layers == {'text': 48, 'crosskv': 32, 'spatial': 96} and
          finite, f'fusion: layers solved {layers}, finite {finite}')

    t0 = time.perf_counter()
    fused = zoo.load_models(ckpt, dev)
    torch.cuda.synchronize()
    t_load = time.perf_counter() - t0
    vocab = fused.text_encoder.cfg.vocab_size
    check(vocab == 49408 + 96 and len(fused.tokenizer) == vocab,
          f'fusion: reloaded vocabulary {vocab}')
    base = zoo.load_models('random:sd15', dev, seed=0)
    changed = {}
    for model in ('unet', 'text_encoder', 'vae'):
        fs = getattr(fused, model).state_dict()
        for k, want_t in getattr(base, model).state_dict().items():
            got = fs[k]
            if k == 'token_embedding.weight':
                check(torch.equal(got[:want_t.shape[0]], want_t),
                      'fusion: the base vocabulary rows moved')
                continue
            path = k[:-len('.weight')].replace('.', '/')
            if k.endswith('.weight') and path in leaves.get(model, ()):
                changed[path] = (got - want_t).abs().max().item()
            else:
                check(torch.equal(got, want_t),
                      f'fusion: {model} {k} moved without a delta')
    del base
    check(len(changed) == 48 + 128 and min(changed.values()) > 0,
          f'fusion: {len(changed)} LoRA layers, smallest change '
          f'{min(changed.values())}')

    adapter = zoo.load_t2i_adapter('keypose', 'sd15', dev, seed=3,
                                   dtype=torch.bfloat16)
    pipe = RegionallyT2IAdapterPipeline(
        fused.unet, fused.text_encoder, fused.vae, fused.tokenizer, dev,
        torch.bfloat16, new_concept_cfg=new_cfg, keypose_adapter=adapter)
    layout = [('three people standing in a park, best quality', REGIONS)]
    lat = torch.randn((2, 4, 64, 64), device=dev,
                      generator=torch.Generator(device=dev).manual_seed(2))
    before = ops.launch_counts()
    t0 = time.perf_counter()
    out = pipe(layout, keypose_adapter_input=Image.open(POSE).convert(
        'RGB'), height=512, width=512, num_inference_steps=50,
        guidance_scale=7.5, num_images_per_prompt=2, latents=lat,
        output_type='uint8')
    t_req = time.perf_counter() - t0
    after = ops.launch_counts()
    req = {k: after[k] - before[k] for k in after}
    check(out.shape == (2, 512, 512, 3) and
          all(int(im.max()) > int(im.min()) for im in out),
          f'fusion: the regional request gave {out.shape}')
    check(req['region_attn'] == 16 * 50 and
          all(req[k] > 0 for k in PLAIN_PATH_KERNELS) and
          all(req[k] == 0 for k in FLASH_KERNELS),
          f'fusion: regional launches {req}')
    sec = report['seconds']
    print(f'[fusion] SD1.5 gradient fusion through gradient_fusion.main, 3 '
          f'concepts, exact solve, {FUSION_STEPS} spatial steps at 512x512, '
          f'bf16 capture: whole {sec["total"]:.2f} s ('
          + ', '.join(f'{k} {v:.2f}' for k, v in sec.items() if k != 'total')
          + f' s); layers {layers}; peak device memory {peak / 2 ** 30:.2f} '
          f'GiB; launches {counts} ({evals} capture evals); smallest change '
          f'of a LoRA layer {min(changed.values()):.3e}; reload {t_load:.2f}'
          f' s, vocabulary {vocab}; regional request on the fused model '
          f'(3 regions, keypose, 2 images 512x512, 50 steps, CFG 7.5) '
          f'{t_req:.3f} s ({2 / t_req:.4f} img/s), launches {req}; {card}',
          flush=True)
    return {k: counts[k] + req[k] for k in counts}, ckpt


def original_layout(sd, nums_rb):
    """The port's (diffusers-named) adapter state dict in the original
    TencentARC layout: body.{i}.resnets.{j}.X -> body.{i*nums_rb+j}.X,
    body.{i}.in_conv.X -> body.{i*nums_rb}.in_conv.X."""
    out = {}
    for k, v in sd.items():
        m = re.match(r'body\.(\d+)\.resnets\.(\d+)\.(.*)', k)
        if m:
            out[f'body.{int(m[1]) * nums_rb + int(m[2])}.{m[3]}'] = v
            continue
        m = re.match(r'body\.(\d+)\.in_conv\.(.*)', k)
        out[f'body.{int(m[1]) * nums_rb}.in_conv.{m[2]}' if m else k] = v
    return out


ADAPTER_SEEDS = {'keypose': 3, 'sketch': 4}


def _write_adapters(dev, root):
    """Seeded full-width adapters on disk: keypose in the TencentARC layout
    (pytorch_model.bin), sketch in the diffusers layout with the
    'adapter.' prefix (diffusion_pytorch_model.safetensors). Returns
    {kind: directory}."""
    dirs = {}
    for kind, seed in ADAPTER_SEEDS.items():
        a = zoo.load_t2i_adapter(kind, 'sd15', dev, seed=seed)
        sd = {k: t.cpu() for k, t in a.state_dict().items()}
        dirs[kind] = root / kind
        dirs[kind].mkdir(parents=True)
        if kind == 'keypose':
            torch.save(original_layout(sd, a.cfg.num_res_blocks),
                       dirs[kind] / 'pytorch_model.bin')
        else:
            safetensors_io.save_file(
                {f'adapter.{k}': t for k, t in sd.items()},
                str(dirs[kind] / 'diffusion_pytorch_model.safetensors'))
    return dirs


def _check_adapters(dev, dirs):
    """Each adapter as the CLI loads it (regional_cli.load_adapter, bf16)
    gives the seeded module's features bitwise on the layout's images."""
    images = {'keypose': Image.open(POSE).convert('RGB'),
              'sketch': Image.open(POSE.with_name(POSE.name.replace(
                  '_pose', '_sketch'))).convert('L')}
    for kind, seed in ADAPTER_SEEDS.items():
        got = regional_cli.load_adapter(str(dirs[kind]), kind, 'sd15', dev,
                                        torch.bfloat16)
        want = zoo.load_t2i_adapter(kind, 'sd15', dev, seed=seed,
                                    dtype=torch.bfloat16)
        x = torch.from_numpy(preprocess_adapter_image(
            images[kind], 512, 1024)).permute(0, 3, 1, 2).to(
                dev, torch.bfloat16)
        with torch.inference_mode():
            same = all(torch.equal(a, b) for a, b in zip(got(x), want(x)))
        check(same, f'cli: the converted {kind} adapter differs from the '
              'seeded one')
    print(f'[cli] adapters: keypose written in the TencentARC layout, '
          f'sketch in the diffusers layout; converted features equal the '
          f'seeded modules\' bitwise (bf16, {POSE.name} and its sketch)',
          flush=True)


def _cli_run(name, dev, card, argv, k1, n_images, canvas):
    """One request through regional_cli.main with `argv`; checks its files,
    images and launches (K1 `k1`, K7 800, K2 and K8 30, K3 1)."""
    buf = io.StringIO()
    report = {}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    with contextlib.redirect_stdout(buf):
        files = regional_cli.main(argv + ['--device', str(dev)],
                                  report=report)
    counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    said = buf.getvalue()
    check('random init' not in said, f'cli {name}: an adapter was random:'
          f' {said}')
    args = regional_cli.parse_args(argv)
    stem = re.escape(args.prompt.replace(' ', '_'))
    check(len(files) == n_images, f'cli {name}: files {files}')
    images = []
    for i, f in enumerate(files):
        m = re.fullmatch(stem + f'---{re.escape(args.suffix)}---'
                         r'([0-9a-f]{8})' + (f'---{i}' if n_images > 1
                                             else '') + r'\.png',
                         os.path.basename(f))
        txt = Path(f[:-4] + '.txt')
        check(m is not None and Path(f).parent.name == f'seed_{args.seed}'
              and txt.exists(), f'cli {name}: {f}')
        check(hashlib.sha256(txt.read_bytes()).hexdigest()[:8] == m[1],
              f'cli {name}: {f} is not named by the hash of its .txt')
        img = np.asarray(Image.open(f))
        check(img.shape == (*canvas, 3) and int(img.max()) > int(img.min()),
              f'cli {name}: {f} is {img.shape}, range {img.min()} to '
              f'{img.max()}')
        images.append(img)
    if n_images > 1:
        check(not np.array_equal(images[0], images[1]),
              f'cli {name}: its images are the same')
    want = {k: 0 for k in counts}
    want.update(attn_fwd=k1, region_attn=16 * 50, gn_spatial_sums=30,
                gn_apply=30, attn_block=1)
    check(counts == want, f'cli {name}: launches {counts}, expected {want}')
    # K1 by design: the two layers of heads 40 and 80 wide (at 1024x2048
    # the res-128 layer's 32,768 keys among them) on the ping-pong kernel,
    # the res-32 layer's 160-wide heads (2048 tokens, 1024x2048 only) on
    # the lock-step one
    routes = dict(fa.attn_fwd.routes)
    want_routes = {'pingpong': 500, 'lockstep': k1 - 500}
    check(routes == {r: n for r, n in want_routes.items() if n},
          f'cli {name}: K1 routes {routes}, expected {want_routes}')
    print(f'[cli] {name}: {canvas[0]}x{canvas[1]}, {n_images} image(s), '
          f'{args.num_inference_steps} steps, seed {args.seed}: load '
          f'{report["load_s"]:.3f} s, sampling {report["sample_s"]:.3f} s, '
          f'save {report["save_s"]:.3f} s; peak device memory '
          f'{peak / 2 ** 30:.2f} GiB (max_memory_allocated, load '
          f'included); files {[os.path.basename(f) for f in files]}; '
          f'launches {counts}; K1 routes {routes}; {card}', flush=True)
    return counts


def phase_cli(dev, card, ckpt, root):
    """Phase 9: the regional CLI on phase 8's fused directory."""
    dirs = _write_adapters(dev, root / 'adapters')
    _check_adapters(dev, dirs)
    adapters = ['--keypose_adapter_path', str(dirs['keypose']),
                '--sketch_adapter_path', str(dirs['sketch'])]
    runs = []
    for name, txt, sketch, n in (('9a', LAYOUT_1X, True, 2),
                                 ('9b', LAYOUT_2X, False, 1)):
        lay = read_layout(txt)
        stem = str(txt)[:-4]
        argv = ['--pretrained_model', str(ckpt),
                '--keypose_condition', stem + '_pose.png',
                '--prompt', lay['context_prompt'],
                '--negative_prompt', lay['context_neg_prompt'],
                '--prompt_rewrite', layout_rewrite(lay),
                '--save_dir', str(root / name), '--suffix', name,
                '--seed', '19', '--num_inference_steps', '50',
                '--num_images_per_prompt', str(n)] + adapters
        if sketch:
            argv += ['--sketch_condition', stem + '_sketch.png']
        w, h = Image.open(stem + '_pose.png').size
        runs.append(_cli_run(name, dev, card, argv, 10 * 50 if h == 512
                             else 15 * 50, n, (h, w)))
    # 9c: regionally_sample.sh's own arguments, the adapters added
    var = sample_sh_args()
    argv = ['--pretrained_model', str(ckpt),
            f'--sketch_adaptor_weight={var["sketch_adaptor_weight"]}',
            f'--sketch_condition={var["sketch_condition"]}',
            f'--keypose_adaptor_weight={var["keypose_adaptor_weight"]}',
            f'--keypose_condition={ROOT / var["keypose_condition"]}',
            f'--save_dir={root / "9c" / var["expdir"]}',
            f'--prompt={var["context_prompt"]}',
            f'--negative_prompt={var["context_neg_prompt"]}',
            f'--prompt_rewrite={var["prompt_rewrite"]}',
            '--suffix=baseline', '--seed=19'] + adapters
    runs.append(_cli_run('9c', dev, card, argv, 10 * 50, 1, (512, 1024)))
    return {k: sum(r[k] for r in runs) for k in runs[0]}


def main():
    dev = require_cuda()
    card = smi_line()
    print(f'[device] {torch.cuda.get_device_name(0)} | nvidia-smi: {card} | '
          f'torch {torch.__version__} CUDA {torch.version.cuda}', flush=True)
    phase_build(dev)
    kres = phase_kernels(dev)
    int8 = phase_int8_table(dev, card)
    phase_wiring(dev)
    phase_wiring_train(dev)
    phase_wiring_fusion(dev)
    plain = phase_main(dev, card)
    regional = phase_regional(dev, card)
    scratch = Path(tempfile.mkdtemp(prefix='mos_chip_train_'))
    try:
        delta = scratch / 'hermione.pth'
        train, phase7 = phase_train(dev, card, scratch, delta)
        resume, archived = phase_resume(dev, card, scratch, phase7)
        sweep = phase_test_edlora(dev, card, scratch, delta, archived,
                                  phase7)
        phase_ddp(card, scratch, archived)
        fusion, ckpt = phase_fusion(dev, card, delta, scratch / 'fusion')
        cli = phase_cli(dev, card, ckpt, scratch / 'cli')
    finally:
        shutil.rmtree(scratch, ignore_errors=True)
    runs = (plain, regional, train, resume, sweep, fusion, cli)
    kernels = [{'name': name, 'route': route, 'source': src,
                'replaces': rep, 'launches': sum(p[name] for p in runs),
                **kres[name]}
               for name, (route, src, rep) in KERNEL_META.items()]
    print('INT8_TABLE ' + json.dumps(int8))
    print(json.dumps({'kernels': kernels}))
    print(card)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))


if __name__ == '__main__':
    main()
