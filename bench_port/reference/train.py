"""Plain fp32 reference of ED-LoRA training steps (Mix-of-Show's
EDLoRATrainer, trainer_edlora.py): the concept table and LoRA trees a run
of the seed starts from, the masked diffusion loss plus the
cross-attention regularizer, and AdamW over three groups with a linear
decay and the sticky embedding freeze. Imports nothing of the program.

Start: concept k's 16 rows are one vector, drawn as numpy's
default_rng(seed).normal(0, 1, width) × σ for an initializer `<rand-σ>`,
or the token embedding of an initializer word; then, from the same
generator, each LoRA down as U[±1/√in] of shape (in, rank), transposed,
and each up zeros, text sites before UNet sites, the UNet's in the order
down blocks, up blocks, mid block (the JAX parameter tree's).
"""
from __future__ import annotations

import math
import re

import numpy as np
import torch
import torch.nn.functional as F

from bench_port.reference import sd15, text

GROUPS = ('emb', 'text', 'unet')


def lora_sites(cfg):
    """'/'-joined paths of the LoRA'd linears: text, then UNet."""
    out = []
    for i in range(cfg['text_encoder']['layers']):
        out += [f'text/blocks/{i}/attn/{n}' for n in ('q', 'k', 'v', 'out')]
    u = cfg['unet']
    per = u['layers_per_block']
    places = []
    for i, cross in enumerate(u['down_cross']):
        if cross:
            places += [f'down_blocks/{i}/attentions/{j}' for j in range(per)]
    for i, cross in enumerate(reversed(u['down_cross'])):
        if cross:
            places += [f'up_blocks/{i}/attentions/{j}'
                       for j in range(per + 1)]
    places.append('mid/attention')
    for p in places:
        for a in ('attn1', 'attn2'):
            out += [f'unet/{p}/{a}/{n}' for n in ('to_q', 'to_k', 'to_v',
                                                  'to_out')]
    return out


def start(cfg, train, ref, seed, device):
    """{leaf: fp32 tensor} the run starts from: 'concept_embedding' and
    'text/...', 'unet/...' LoRA downs and ups."""
    rng = np.random.default_rng(seed)
    width = cfg['text_encoder']['width']
    rows = []
    names = train['new_concept_token'].split('+')
    inits = train['initializer_token'].split('+')
    table = ref.text_encoder.token_embedding.weight
    for name, init in zip(names, inits):
        m = re.findall(r'<rand-(.*)>', init)
        if m:
            feat = rng.normal(0.0, 1.0, (width,)) * float(m[0])
            feat = torch.as_tensor(feat, dtype=torch.float32)
        else:
            feat = table[text.piece_id(init)].detach().float().cpu()
        rows += [feat] * sd15.NUM_LAYERS
    out = {'concept_embedding': torch.stack(rows).to(device)}
    rank = train['rank']
    for path in lora_sites(cfg):
        mod = ref.text_encoder if path.startswith('text/') else ref.unet
        lin = mod
        for part in path.split('/')[1:]:
            lin = lin[int(part)] if part.isdigit() else getattr(lin, part)
        fan_out, fan_in = lin.weight.shape
        bound = 1.0 / math.sqrt(fan_in)
        down = rng.uniform(-bound, bound, (fan_in, rank)).astype(
            np.float32).T
        out[f'{path}/down'] = torch.as_tensor(np.ascontiguousarray(down),
                                              device=device)
        out[f'{path}/up'] = torch.zeros((fan_out, rank), device=device)
    return out


def tree(leaves, prefix):
    """The nested LoRA dict of the leaves under `prefix`."""
    root: dict = {}
    for name, t in leaves.items():
        if not name.startswith(prefix + '/'):
            continue
        node = root
        parts = name[len(prefix) + 1:].split('/')
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = t
    return root or None


def nearest(x, hw):
    return x if tuple(x.shape[-2:]) == tuple(hw) else F.interpolate(
        x, size=tuple(hw), mode='nearest-exact')


def attn_reg(probs, masks, pos_mask, weight, hw):
    """The mass of each concept token's normalized cross-attention map
    outside the instance mask, per resolution; probs [(B, heads, Q, 2)]
    at the [adjective, subject] token columns."""
    h0, w0 = hw
    b = masks.shape[0]
    groups: dict = {}
    for p in probs:
        s = int(round((h0 * w0 / p.shape[2]) ** 0.5))
        groups.setdefault(s, []).append(p)
    mask = masks.permute(0, 3, 1, 2)
    total = torch.zeros((), device=masks.device)
    for s, plist in sorted(groups.items()):
        h, w = h0 // s, w0 // s
        amap = torch.cat(plist, 1).mean(1).reshape(b, h, w, 2)
        amap = amap * pos_mask[:, None, None, :]
        adj, subj = amap[..., 0], amap[..., 1]
        subj = subj / (subj.max() + 1e-12)
        adj = adj / (adj.max() + 1e-12)
        outside = 1.0 - nearest(mask, (h, w))[:, 0]
        n_out = outside.sum()
        denom = torch.clamp(n_out, min=1.0)
        loss = (subj * outside).sum() / denom + (adj * outside).sum() / denom
        total = total + weight * (n_out > 0).float() * loss
    return total


class Trainer:
    """The reference's train steps on `ref` (build.reference) from the
    leaves `start` gives, drawing each step's noise from `gen` in the
    program's order: VAE eps and noise (B, 4, h, w), noise offset
    (B, 4, 1, 1), timesteps (B,)."""

    def __init__(self, cfg, train, ref, leaves, gen, total_steps):
        self.cfg, self.train, self.ref, self.gen = cfg, train, ref, gen
        self.leaves = {k: v.clone().requires_grad_(True)
                       for k, v in leaves.items()}
        lr = train['lr']
        groups = {'emb': ['concept_embedding'],
                  'text': [k for k in self.leaves if k.startswith('text/')],
                  'unet': [k for k in self.leaves if k.startswith('unet/')]}
        self.opt = torch.optim.AdamW(
            [{'params': [self.leaves[k] for k in groups[g]], 'lr': lr[g],
              'weight_decay': train['weight_decay']} for g in GROUPS],
            betas=tuple(train['betas']), eps=1e-8)
        self.sched = torch.optim.lr_scheduler.LambdaLR(
            self.opt, lambda u: 1.0 - min(u, total_steps) / total_steps)
        self.frozen = False
        betas = np.linspace(0.00085 ** 0.5, 0.012 ** 0.5, 1000,
                            dtype=np.float64) ** 2
        acp = torch.as_tensor(np.cumprod(1.0 - betas), dtype=torch.float32,
                              device=gen.device)
        self.sqrt_a, self.sqrt_s = acp.sqrt(), (1.0 - acp).sqrt()

    def loss(self, batch):
        """(total loss, MSE, regularizer) of one batch: 'images' (B, H, W,
        3), 'masks' (B, h, w, 1), 'ids' (B, 16, 77), 'pos' (B, 2),
        'pos_mask' (B, 2), tensors on the device."""
        ref, t = self.ref, self.train
        dev = self.gen.device
        images = batch['images'].permute(0, 3, 1, 2)
        b = images.shape[0]
        lat_hw = (images.shape[2] // 8, images.shape[3] // 8)
        shape = (b, 4, *lat_hw)
        kw = dict(generator=self.gen, device=dev, dtype=torch.float32)
        eps = torch.randn(shape, **kw)
        noise = torch.randn(shape, **kw)
        offset = torch.randn((b, 4, 1, 1), **kw)
        ts = torch.randint(0, 1000, (b,), generator=self.gen, device=dev)
        with torch.no_grad():
            mean, logvar = ref.vae.encode(images)
            latents = (mean + torch.exp(0.5 * logvar) * eps) * \
                self.cfg['vae']['scaling_factor']
        noise = noise + t['noise_offset'] * offset
        noisy = self.sqrt_a[ts][:, None, None, None] * latents + \
            self.sqrt_s[ts][:, None, None, None] * noise
        ids = batch['ids']
        ctx = ref.text_encoder(ids.reshape(-1, ids.shape[-1]),
                               self.leaves['concept_embedding'],
                               tree(self.leaves, 'text'), t['alpha'])
        ctx = ctx.reshape(b, sd15.NUM_LAYERS, *ctx.shape[1:])
        probs = []
        pred = ref.unet(noisy, ts, ctx, tree(self.leaves, 'unet'),
                        t['alpha'], probs=probs, prob_columns=batch['pos'])
        mask = nearest(batch['masks'].permute(0, 3, 1, 2), pred.shape[-2:])
        se = (pred - noise) ** 2
        mse = ((se * mask).sum((1, 2, 3)) /
               torch.clamp(mask.sum((1, 2, 3)), min=1.0)).mean()
        reg = attn_reg(probs, batch['masks'], batch['pos_mask'],
                       t['attn_reg_weight'], lat_hw)
        return mse + reg, mse, reg

    def step(self, batch):
        """One update; returns (loss, mse, reg) as floats and the
        gradients the optimizer was given."""
        total, mse, reg = self.loss(batch)
        total.backward()
        grads = {k: v.grad.detach().clone() for k, v in self.leaves.items()}
        emb = self.leaves['concept_embedding']
        before = emb.detach().clone()
        self.opt.step()
        self.sched.step()
        self.opt.zero_grad(set_to_none=True)
        with torch.no_grad():
            if self.frozen:
                emb.copy_(before)
            norm = emb.norm(dim=-1).mean()
            self.frozen = self.frozen or bool(
                norm >= self.train['emb_norm_threshold'])
        return (total.item(), mse.item(), reg.item()), grads
