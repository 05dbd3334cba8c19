"""Plain fp32 reference of SD1.x sampling with ED-LoRA concepts, regional
cross-attention and a T2I-Adapter, in plain PyTorch.

It imports nothing of the program under test. Module and parameter names
follow the published SD1.5 layout in the port's naming, so that one seeded
draw of weights (bench_port/weights.py) fills this model and the program's
alike. Every product runs in fp32 with TF32 off (`exact_fp32`); attention is
an explicit softmax, computed over blocks of queries so that 32,768-token
self-attention fits; norms are `F.group_norm` / `F.layer_norm`.

The equations are those of diffusers' UNet2DConditionModel (SD1.x),
CLIPTextModel (openai/clip-vit-large-patch14), AutoencoderKL, T2IAdapter
('full_adapter'), DPMSolverMultistepScheduler (solver_order 2,
dpmsolver++, linspace spacing), and Mix-of-Show's layer-wise concept
prompts and regional blend (the overlap-counted mean of each region's
cross-attention inside its box).
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

NUM_LAYERS = 16          # cross-attention layers of SD1.5, down -> mid -> up
QUERY_BLOCK = 1024       # attention queries computed at once


def exact_fp32():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision('highest')


def _round(x, dtype, top):
    with torch.no_grad():
        scale = x.abs().amax().clamp(min=1e-30) / top
        return (x / scale).to(dtype).float() * scale


class _Fp8(torch.autograd.Function):
    """float8 e4m3 forward, the gradient rounded to e5m2 on the way back,
    each under one scale a tensor, as fp8 training computes them."""

    @staticmethod
    def forward(ctx, x):
        return _round(x, torch.float8_e4m3fn, 448.0)

    @staticmethod
    def backward(ctx, grad):
        return _round(grad, torch.float8_e5m2, 57344.0)


def fp8(x):
    """x rounded to float8 e4m3 under one scale (amax / 448), as float32;
    its gradient, where one flows, rounded to e5m2."""
    if torch.is_grad_enabled() and x.requires_grad:
        return _Fp8.apply(x)
    return _round(x, torch.float8_e4m3fn, 448.0)


def to_fp8_(model: nn.Module) -> nn.Module:
    """The control of the correctness check: every linear and convolution
    of `model` takes float8 e4m3 operands (weights rounded here, in place,
    one scale a tensor; inputs rounded at each call, their gradients to
    e5m2), accumulating in float32, as fp8 tensor cores compute them."""
    for mod in model.modules():
        if isinstance(mod, (nn.Linear, nn.Conv2d)):
            mod.weight.data = _round(mod.weight.data, torch.float8_e4m3fn,
                                     448.0)
            mod.fp8 = True
            if isinstance(mod, nn.Conv2d):
                mod.register_forward_pre_hook(lambda m, a: (fp8(a[0]),))
    return model


def operand(x, mod):
    return fp8(x) if getattr(mod, 'fp8', False) else x


def lin(x, mod, lora=None, alpha=1.0):
    """x Wᵀ + b, plus alpha · (x downᵀ) upᵀ."""
    y = F.linear(operand(x, mod), mod.weight, mod.bias)
    if lora is not None:
        y = y + alpha * F.linear(F.linear(x, lora['down']), lora['up'])
    return y


def sub(tree, *names):
    for n in names:
        if tree is None:
            return None
        tree = tree.get(str(n))
    return tree


def attention(q, k, v, causal=False):
    """softmax(q kᵀ / √D) v over (B, S, H, D) in fp32, queries in blocks."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    out = torch.empty_like(q)
    sk = k.shape[1]
    for s in range(0, q.shape[1], QUERY_BLOCK):
        qb = q[:, s:s + QUERY_BLOCK]
        logits = torch.einsum('bqhd,bkhd->bhqk', qb, k) * scale
        if causal:
            rows = torch.arange(s, s + qb.shape[1], device=q.device)[:, None]
            cols = torch.arange(sk, device=q.device)[None, :]
            logits = logits.masked_fill(cols > rows, float('-inf'))
        out[:, s:s + QUERY_BLOCK] = torch.einsum(
            'bhqk,bkhd->bqhd', torch.softmax(logits, -1), v)
    return out


# ------------------------------------------------------------------ CLIP
class CLIPText(nn.Module):
    def __init__(self, vocab=49408, width=768, layers=12, heads=12,
                 mlp=3072, positions=77):
        super().__init__()
        self.heads = heads
        self.token_embedding = nn.Embedding(vocab, width)
        self.position_embedding = nn.Embedding(positions, width)
        self.final_norm = nn.LayerNorm(width)
        self.blocks = nn.ModuleList()
        for _ in range(layers):
            blk = nn.Module()
            blk.ln1, blk.ln2 = nn.LayerNorm(width), nn.LayerNorm(width)
            blk.attn = nn.Module()
            for n in ('q', 'k', 'v', 'out'):
                setattr(blk.attn, n, nn.Linear(width, width))
            blk.mlp = nn.Module()
            blk.mlp.fc1 = nn.Linear(width, mlp)
            blk.mlp.fc2 = nn.Linear(mlp, width)
            self.blocks.append(blk)

    def forward(self, ids, concept_table=None, lora=None, alpha=1.0):
        """ids (B, 77) int64; ids >= vocab index `concept_table`."""
        table = self.token_embedding.weight
        if concept_table is not None:
            table = torch.cat([table, concept_table])
        x = table[ids] + self.position_embedding.weight[:ids.shape[1]]
        b, s, c = x.shape
        h = self.heads
        for i, blk in enumerate(self.blocks):
            a = F.layer_norm(x, (c,), blk.ln1.weight, blk.ln1.bias, 1e-5)
            al = sub(lora, 'blocks', i, 'attn')
            q, k, v = (lin(a, getattr(blk.attn, n), sub(al, n), alpha)
                       .view(b, s, h, c // h) for n in ('q', 'k', 'v'))
            o = attention(q, k, v, causal=True).reshape(b, s, c)
            x = x + lin(o, blk.attn.out, sub(al, 'out'), alpha)
            m = F.layer_norm(x, (c,), blk.ln2.weight, blk.ln2.bias, 1e-5)
            m = lin(m, blk.mlp.fc1)
            x = x + lin(m * torch.sigmoid(1.702 * m), blk.mlp.fc2)
        return F.layer_norm(x, (c,), self.final_norm.weight,
                            self.final_norm.bias, 1e-5)


# ------------------------------------------------------------------ UNet
def gn(x, norm, eps, act=False):
    y = F.group_norm(x, norm.num_groups, norm.weight, norm.bias, eps)
    return F.silu(y) if act else y


class Resnet(nn.Module):
    def __init__(self, cin, cout, temb, groups, eps):
        super().__init__()
        self.eps = eps
        self.norm1 = nn.GroupNorm(groups, cin)
        self.conv1 = nn.Conv2d(cin, cout, 3, padding=1)
        if temb:
            self.time_emb_proj = nn.Linear(temb, cout)
        self.norm2 = nn.GroupNorm(groups, cout)
        self.conv2 = nn.Conv2d(cout, cout, 3, padding=1)
        self.shortcut = nn.Conv2d(cin, cout, 1) if cin != cout else None

    def forward(self, x, temb=None):
        h = self.conv1(gn(x, self.norm1, self.eps, True))
        if temb is not None:
            h = h + lin(temb, self.time_emb_proj)[:, :, None, None]
        h = self.conv2(gn(h, self.norm2, self.eps, True))
        return (x if self.shortcut is None else self.shortcut(x)) + h


class Attn(nn.Module):
    def __init__(self, c, ctx):
        super().__init__()
        self.to_q = nn.Linear(c, c, bias=False)
        self.to_k = nn.Linear(ctx, c, bias=False)
        self.to_v = nn.Linear(ctx, c, bias=False)
        self.to_out = nn.Linear(c, c)


class Transformer(nn.Module):
    def __init__(self, c, ctx, groups):
        super().__init__()
        self.norm = nn.GroupNorm(groups, c)
        self.proj_in = nn.Conv2d(c, c, 1)
        self.ln1, self.ln2, self.ln3 = (nn.LayerNorm(c) for _ in range(3))
        self.attn1 = Attn(c, c)
        self.attn2 = Attn(c, ctx)
        self.ff = nn.Module()
        self.ff.proj = nn.Linear(c, 8 * c)
        self.ff.out = nn.Linear(4 * c, c)
        self.proj_out = nn.Conv2d(c, c, 1)


class UNet(nn.Module):
    def __init__(self, ch=(320, 640, 1280, 1280), ctx=768, heads=8,
                 groups=32, per_block=2,
                 down_cross=(True, True, True, False)):
        super().__init__()
        self.heads, self.ch = heads, ch
        self.down_cross, self.per_block = down_cross, per_block
        temb = 4 * ch[0]
        self.conv_in = nn.Conv2d(4, ch[0], 3, padding=1)
        self.time_embedding = nn.ModuleDict({
            'linear_1': nn.Linear(ch[0], temb),
            'linear_2': nn.Linear(temb, temb)})
        self.down_blocks = nn.ModuleList()
        cin = ch[0]
        for i, cross in enumerate(down_cross):
            blk = nn.Module()
            blk.resnets, blk.attentions = nn.ModuleList(), nn.ModuleList()
            for _ in range(per_block):
                blk.resnets.append(Resnet(cin, ch[i], temb, groups, 1e-5))
                cin = ch[i]
                if cross:
                    blk.attentions.append(Transformer(cin, ctx, groups))
            if i < len(ch) - 1:
                blk.downsample = nn.Conv2d(cin, cin, 3, stride=2, padding=1)
            self.down_blocks.append(blk)
        self.mid = nn.Module()
        self.mid.resnet1 = Resnet(cin, cin, temb, groups, 1e-5)
        self.mid.attention = Transformer(cin, ctx, groups)
        self.mid.resnet2 = Resnet(cin, cin, temb, groups, 1e-5)
        self.up_blocks = nn.ModuleList()
        rev = list(reversed(ch))
        for i, cross in enumerate(reversed(down_cross)):
            blk = nn.Module()
            blk.resnets, blk.attentions = nn.ModuleList(), nn.ModuleList()
            skip_last = rev[min(i + 1, len(ch) - 1)]
            for j in range(per_block + 1):
                skip = rev[i] if j < per_block else skip_last
                blk.resnets.append(Resnet(cin + skip, rev[i], temb, groups,
                                          1e-5))
                cin = rev[i]
                if cross:
                    blk.attentions.append(Transformer(cin, ctx, groups))
            if i < len(ch) - 1:
                blk.upsample = nn.Conv2d(cin, cin, 3, padding=1)
            self.up_blocks.append(blk)
        self.norm_out = nn.GroupNorm(groups, cin)
        self.conv_out = nn.Conv2d(cin, 4, 3, padding=1)

    def transformer(self, t, x, ctx, lora, alpha, cross, probs=None,
                    columns=None):
        """cross(attn2, a, (h, w)) replaces the cross-attention when given;
        with a `probs` list the cross-attention's probabilities at the key
        `columns` (B, K) are appended to it, (B, heads, Q, K)."""
        b, c, h, w = x.shape
        heads = self.heads
        d = c // heads
        hid = t.proj_in(gn(x, t.norm, 1e-6))
        hid = hid.permute(0, 2, 3, 1).reshape(b, h * w, c)

        def ln(v, m):
            return F.layer_norm(v, (c,), m.weight, m.bias, 1e-5)

        def mha(p, a, context, pl, keep=None):
            q = lin(a, p.to_q, sub(pl, 'to_q'), alpha).view(b, -1, heads, d)
            k = lin(context, p.to_k, sub(pl, 'to_k'), alpha).view(
                b, -1, heads, d)
            v = lin(context, p.to_v, sub(pl, 'to_v'), alpha).view(
                b, -1, heads, d)
            if keep is None:
                o = attention(q, k, v)
            else:
                pr = torch.softmax(torch.einsum('bqhd,bkhd->bhqk', q, k)
                                   / math.sqrt(d), -1)
                o = torch.einsum('bhqk,bkhd->bqhd', pr, v)
                keep.append(pr.gather(-1, columns[:, None, None, :].expand(
                    *pr.shape[:3], columns.shape[-1])))
            return lin(o.reshape(b, -1, c), p.to_out, sub(pl, 'to_out'),
                       alpha)

        a = ln(hid, t.ln1)
        hid = hid + mha(t.attn1, a, a, sub(lora, 'attn1'))
        a = ln(hid, t.ln2)
        if cross is None:
            hid = hid + mha(t.attn2, a, ctx, sub(lora, 'attn2'), probs)
        else:
            hid = hid + cross(t.attn2, a, (h, w))
        a = ln(hid, t.ln3)
        val, gate = lin(a, t.ff.proj).chunk(2, -1)
        hid = hid + lin(val * F.gelu(gate), t.ff.out)
        hid = hid.reshape(b, h, w, c).permute(0, 3, 1, 2)
        return t.proj_out(hid) + x

    def forward(self, sample, t, ctx_layers, lora=None, alpha=1.0,
                adapter=None, cross=None, probs=None, prob_columns=None):
        """sample (B, 4, h, w); t an int or (B,) ints; ctx_layers
        (B, 16, 77, C), one
        context per cross-attention layer; `adapter` the T2I-Adapter's
        features, added after each down block (diffusers 0.19: onto the last
        residual of a block with cross-attention, not of a plain block);
        `cross(layer_idx)` returns the cross-attention override of that
        layer, or None; `probs` and `prob_columns` as in `transformer`,
        for every layer in order."""
        half = self.ch[0] // 2
        freqs = torch.exp(-math.log(10000) * torch.arange(
            half, dtype=torch.float32, device=sample.device) / half)
        t = torch.as_tensor(t, device=sample.device).float().reshape(-1)
        args = t.expand(sample.shape[0])[:, None] * freqs[None]
        temb = torch.cat([torch.cos(args), torch.sin(args)], -1)
        temb = lin(F.silu(lin(temb, self.time_embedding['linear_1'])),
                   self.time_embedding['linear_2'])
        temb = F.silu(temb)
        idx = 0

        def tfm(mod, x, path):
            nonlocal idx
            out = self.transformer(mod, x, ctx_layers[:, idx],
                                   sub(lora, *path), alpha,
                                   None if cross is None else cross(idx),
                                   probs, prob_columns)
            idx += 1
            return out

        x = self.conv_in(sample)
        res = [x]
        for i, blk in enumerate(self.down_blocks):
            for j, r in enumerate(blk.resnets):
                x = r(x, temb)
                if self.down_cross[i]:
                    x = tfm(blk.attentions[j], x,
                            ('down_blocks', i, 'attentions', j))
                res.append(x)
            if adapter is not None:
                x = x + adapter[i]
                if self.down_cross[i]:
                    res[-1] = x
            if hasattr(blk, 'downsample'):
                x = blk.downsample(x)
                res.append(x)
        x = self.mid.resnet1(x, temb)
        x = tfm(self.mid.attention, x, ('mid', 'attention'))
        x = self.mid.resnet2(x, temb)
        for i, blk in enumerate(self.up_blocks):
            for j, r in enumerate(blk.resnets):
                x = r(torch.cat([x, res.pop()], 1), temb)
                if self.down_cross[len(self.ch) - 1 - i]:
                    x = tfm(blk.attentions[j], x,
                            ('up_blocks', i, 'attentions', j))
            if hasattr(blk, 'upsample'):
                x = blk.upsample(F.interpolate(x, scale_factor=2.0,
                                               mode='nearest'))
        return self.conv_out(gn(x, self.norm_out, 1e-5, True))


# ------------------------------------------------------------------- VAE
class VAEAttn(nn.Module):
    def __init__(self, c, groups):
        super().__init__()
        self.norm = nn.GroupNorm(groups, c)
        self.q, self.k, self.v, self.proj = (nn.Conv2d(c, c, 1)
                                             for _ in range(4))

    def forward(self, x):
        b, c, h, w = x.shape
        t = gn(x, self.norm, 1e-6)

        def proj(conv, v):
            return F.linear(operand(v, conv), conv.weight.view(c, c),
                            conv.bias)

        tok = t.flatten(2).transpose(1, 2)
        q, k, v = (proj(m, tok).view(b, h * w, 1, c)
                   for m in (self.q, self.k, self.v))
        o = proj(self.proj, attention(q, k, v).view(b, h * w, c))
        return x + o.transpose(1, 2).reshape(b, c, h, w)


class VAE(nn.Module):
    """AutoencoderKL: `decode` (post_quant_conv, decoder) for sampling,
    `encode` (encoder, quant_conv) for training."""

    def __init__(self, ch=(128, 256, 512, 512), groups=32, per_block=2):
        super().__init__()
        self.decoder = d = nn.Module()
        cin = ch[-1]
        d.conv_in = nn.Conv2d(4, cin, 3, padding=1)
        d.mid = self._mid(cin, groups)
        d.up = nn.ModuleList()
        for i, cout in enumerate(reversed(ch)):
            st = nn.Module()
            st.resnets = nn.ModuleList()
            for _ in range(per_block + 1):
                st.resnets.append(Resnet(cin, cout, 0, groups, 1e-6))
                cin = cout
            if i < len(ch) - 1:
                st.upsample = nn.Conv2d(cin, cin, 3, padding=1)
            d.up.append(st)
        d.norm_out = nn.GroupNorm(groups, cin)
        d.conv_out = nn.Conv2d(cin, 3, 3, padding=1)
        self.post_quant_conv = nn.Conv2d(4, 4, 1)

        self.encoder = e = nn.Module()
        e.conv_in = nn.Conv2d(3, ch[0], 3, padding=1)
        e.down = nn.ModuleList()
        cin = ch[0]
        for i, cout in enumerate(ch):
            st = nn.Module()
            st.resnets = nn.ModuleList()
            for _ in range(per_block):
                st.resnets.append(Resnet(cin, cout, 0, groups, 1e-6))
                cin = cout
            if i < len(ch) - 1:
                st.downsample = nn.Conv2d(cin, cin, 3, stride=2)
            e.down.append(st)
        e.mid = self._mid(cin, groups)
        e.norm_out = nn.GroupNorm(groups, cin)
        e.conv_out = nn.Conv2d(cin, 8, 3, padding=1)
        self.quant_conv = nn.Conv2d(8, 8, 1)

    @staticmethod
    def _mid(c, groups):
        mid = nn.Module()
        mid.resnet1 = Resnet(c, c, 0, groups, 1e-6)
        mid.attn = VAEAttn(c, groups)
        mid.resnet2 = Resnet(c, c, 0, groups, 1e-6)
        return mid

    def decode(self, z):
        """z (B, 4, h, w), already divided by the scaling factor."""
        d = self.decoder
        x = d.conv_in(self.post_quant_conv(z))
        x = d.mid.resnet2(d.mid.attn(d.mid.resnet1(x)))
        for st in d.up:
            for r in st.resnets:
                x = r(x)
            if hasattr(st, 'upsample'):
                x = st.upsample(F.interpolate(x, scale_factor=2.0,
                                              mode='nearest'))
        return d.conv_out(gn(x, d.norm_out, 1e-6, True))

    def encode(self, img):
        """img (B, 3, H, W) in [-1, 1] -> (mean, logvar clipped to
        [-30, 20]); diffusers pads (0, 1, 0, 1) before each stride-2
        conv."""
        e = self.encoder
        x = e.conv_in(img)
        for st in e.down:
            for r in st.resnets:
                x = r(x)
            if hasattr(st, 'downsample'):
                x = st.downsample(F.pad(x, (0, 1, 0, 1)))
        x = e.mid.resnet2(e.mid.attn(e.mid.resnet1(x)))
        x = e.conv_out(gn(x, e.norm_out, 1e-6, True))
        mean, logvar = self.quant_conv(x).chunk(2, 1)
        return mean, torch.clamp(logvar, -30.0, 20.0)


# --------------------------------------------------------------- adapter
class Adapter(nn.Module):
    """T2IAdapter 'full_adapter': pixel-unshuffle(8), conv_in, four stages
    (2x2 mean pool with ceil mode between them, a 1x1 channel change,
    conv3x3-relu-conv1x1 resnets)."""

    def __init__(self, cin=3, ch=(320, 640, 1280, 1280), nres=2):
        super().__init__()
        self.conv_in = nn.Conv2d(cin * 64, ch[0], 3, padding=1)
        self.body = nn.ModuleList()
        prev = ch[0]
        for c in ch:
            st = nn.Module()
            if prev != c:
                st.in_conv = nn.Conv2d(prev, c, 1)
            st.resnets = nn.ModuleList()
            for _ in range(nres):
                r = nn.Module()
                r.block1 = nn.Conv2d(c, c, 3, padding=1)
                r.block2 = nn.Conv2d(c, c, 1)
                st.resnets.append(r)
            self.body.append(st)
            prev = c

    def forward(self, x):
        h = self.conv_in(F.pixel_unshuffle(x, 8))
        out = []
        for i, st in enumerate(self.body):
            if i:
                h = F.avg_pool2d(h, 2, ceil_mode=True)
            if hasattr(st, 'in_conv'):
                h = st.in_conv(h)
            for r in st.resnets:
                h = h + r.block2(F.relu(r.block1(h)))
            out.append(h)
        return out


# ---------------------------------------------------------------- solver
class DPMSolver:
    """DPM-Solver++(2M) over SD1.x's scaled-linear betas, epsilon
    prediction, linspace timesteps, tables in float64."""

    def __init__(self, steps, train_steps=1000, beta0=0.00085,
                 beta1=0.012):
        betas = np.linspace(beta0 ** 0.5, beta1 ** 0.5, train_steps,
                            dtype=np.float64) ** 2
        acp = np.cumprod(1.0 - betas)
        self.alpha, self.sigma = np.sqrt(acp), np.sqrt(1.0 - acp)
        self.lam = np.log(self.alpha) - np.log(self.sigma)
        self.ts = np.linspace(0, train_steps - 1, steps + 1).round()[
            ::-1][:-1].astype(np.int64)
        self.lower_final = steps < 15

    def sample(self, x, eps_fn):
        """Run every step; eps_fn(x, t) is the guided noise prediction."""
        m_prev, t_prev_s = None, None
        n = len(self.ts)
        for i, t in enumerate(self.ts):
            t_next = self.ts[i + 1] if i + 1 < n else 0
            eps = eps_fn(x, int(t))
            m0 = (x - float(self.sigma[t]) * eps) / float(self.alpha[t])
            h = self.lam[t_next] - self.lam[t]
            first = float(self.sigma[t_next] / self.sigma[t]) * x \
                - float(self.alpha[t_next] * np.expm1(-h)) * m0
            if i > 0 and not (self.lower_final and i == n - 1):
                r0 = float((self.lam[t] - self.lam[t_prev_s]) / h)
                d1 = (m0 - m_prev) / r0
                x = first - float(0.5 * self.alpha[t_next]
                                  * np.expm1(-h)) * d1
            else:
                x = first
            m_prev, t_prev_s = m0, t
        return x


def decode_uint8(vae, latents, scaling_factor):
    """Denoised latents -> (B, H, W, 3) uint8 pixels on the host: decoded,
    mapped from [-1, 1], clamped and rounded, as diffusers' numpy output
    rounds them."""
    img = vae.decode(latents / scaling_factor).float()
    img = torch.clamp(img * 0.5 + 0.5, 0.0, 1.0).permute(0, 2, 3, 1)
    return torch.round(img * 255.0).to(torch.uint8).cpu().numpy()
