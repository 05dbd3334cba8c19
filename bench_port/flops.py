"""Model FLOPs and the least time of kernel work, from the configuration's
shapes alone: what the work needs, whatever computes it.

FLOPs count multiply-adds twice, in the matrix products and convolutions
of the base model (attention's two products included; LoRA, norms and
elementwise work left out), as `torch.utils.flop_counter` counts them. A
roofline's least time is max(bytes / peak bytes/s, FLOPs / peak FLOP/s),
each input byte read once and each output byte written once.
"""
from __future__ import annotations

# NVIDIA H100 SXM (data sheet, dense): bf16 tensor-core FLOP/s, HBM3 bytes/s
PEAK_FLOPS = 989e12
PEAK_BYTES = 3.35e12
BF16 = 2


def conv(cin, cout, k, pixels):
    return 2 * cin * cout * k * k * pixels


def attn(rows, sq, sk, width):
    """QKᵀ and PV over all heads: `width` = heads × head size."""
    return 4 * rows * sq * sk * width


def unet_forward(cfg, h, w, rows=1, ctx_len=77, cross_pixels=None):
    """One UNet forward of `rows` latents of h×w. `cross_pixels(h, w)`
    gives the pixels that attend to a text context at that grid, summed
    over the contexts (default h·w: one context everywhere)."""
    ch = cfg['block_out_channels']
    per = cfg['layers_per_block']
    down_cross = cfg['down_cross']
    ctx = cfg['cross_attention_dim']
    temb = 4 * ch[0]
    cross_pixels = cross_pixels or (lambda hh, ww: hh * ww)
    total = 2 * (ch[0] * temb + temb * temb)

    def resnet(cin, cout, px):
        f = conv(cin, cout, 3, px) + conv(cout, cout, 3, px) + 2 * temb * cout
        return f + (conv(cin, cout, 1, px) if cin != cout else 0)

    def transformer(c, hh, ww):
        px = hh * ww
        f = 2 * conv(c, c, 1, px)                    # proj_in, proj_out
        f += 4 * 2 * c * c * px + attn(1, px, px, c)  # self-attention
        f += 2 * 2 * c * c * px + 2 * 2 * ctx * c * ctx_len  # q, out; k, v
        f += attn(1, cross_pixels(hh, ww), ctx_len, c)
        f += 2 * c * 8 * c * px + 2 * 4 * c * c * px  # GEGLU
        return f

    hh, ww = h, w
    total += conv(cfg['in_channels'], ch[0], 3, hh * ww)
    cin = ch[0]
    skips = [cin]
    for i, cross in enumerate(down_cross):
        for _ in range(per):
            total += resnet(cin, ch[i], hh * ww)
            cin = ch[i]
            if cross:
                total += transformer(cin, hh, ww)
            skips.append(cin)
        if i < len(ch) - 1:
            hh, ww = -(-hh // 2), -(-ww // 2)
            total += conv(cin, cin, 3, hh * ww)
            skips.append(cin)
    total += 2 * resnet(cin, cin, hh * ww) + transformer(cin, hh, ww)
    for i, cross in enumerate(reversed(down_cross)):
        cout = ch[len(ch) - 1 - i]
        for _ in range(per + 1):
            total += resnet(cin + skips.pop(), cout, hh * ww)
            cin = cout
            if cross:
                total += transformer(cin, hh, ww)
        if i < len(ch) - 1:
            hh, ww = hh * 2, ww * 2
            total += conv(cin, cin, 3, hh * ww)
    total += conv(cin, cfg['out_channels'], 3, hh * ww)
    return rows * total


def _vae_resnet(cin, cout, px):
    return conv(cin, cout, 3, px) + conv(cout, cout, 3, px) + (
        conv(cin, cout, 1, px) if cin != cout else 0)


def _vae_mid(c, px):
    return 2 * _vae_resnet(c, c, px) + 4 * 2 * c * c * px + attn(1, px, px, c)


def vae_decode(cfg, h, w, rows=1):
    """Decode of `rows` latents of h×w to 8h×8w images."""
    ch = list(reversed(cfg['block_out_channels']))
    per = cfg['layers_per_block']
    lat = cfg['latent_channels']
    px = h * w
    total = conv(lat, lat, 1, px) + conv(lat, ch[0], 3, px)
    total += _vae_mid(ch[0], px)
    cin = ch[0]
    for i, cout in enumerate(ch):
        for _ in range(per + 1):
            total += _vae_resnet(cin, cout, px)
            cin = cout
        if i < len(ch) - 1:
            px *= 4
            total += conv(cin, cin, 3, px)
    total += conv(cin, cfg['in_channels'], 3, px)
    return rows * total


def vae_encode(cfg, height, width, rows=1):
    """Encode of `rows` images of height×width (the posterior's mean and
    log-variance)."""
    ch = cfg['block_out_channels']
    per = cfg['layers_per_block']
    hh, ww = height, width
    total = conv(cfg['in_channels'], ch[0], 3, hh * ww)
    cin = ch[0]
    for i, cout in enumerate(ch):
        for _ in range(per):
            total += _vae_resnet(cin, cout, hh * ww)
            cin = cout
        if i < len(ch) - 1:
            hh, ww = (hh + 1 - 3) // 2 + 1, (ww + 1 - 3) // 2 + 1
            total += conv(cin, cin, 3, hh * ww)
    total += _vae_mid(cin, hh * ww)
    lat2 = 2 * cfg['latent_channels']
    total += conv(cin, lat2, 3, hh * ww) + conv(lat2, lat2, 1, hh * ww)
    return rows * total


def clip_text(cfg, sequences=1, length=77):
    c, m = cfg['width'], cfg['mlp_dim']
    per_layer = 4 * 2 * c * c * length + attn(1, length, length, c) \
        + 2 * 2 * c * m * length
    return sequences * cfg['layers'] * per_layer


def adapter(cfg, height, width, rows=1):
    """T2I-Adapter features of `rows` condition images."""
    chans = cfg['channels']
    k = cfg['downscale_factor']
    hh, ww = height // k, width // k
    total = conv(cfg['in_channels'] * k * k, chans[0], 3, hh * ww)
    prev = chans[0]
    for i, c in enumerate(chans):
        if i:
            hh, ww = -(-hh // 2), -(-ww // 2)
        if prev != c:
            total += conv(prev, c, 1, hh * ww)
        total += cfg['num_res_blocks'] * (conv(c, c, 3, hh * ww) +
                                          conv(c, c, 1, hh * ww))
        prev = c
    return rows * total


def unet_attention(cfg, h, w, rows=1, ctx_len=77):
    """The attention products (QKᵀ, PV) alone of one UNet forward."""
    ch = cfg['block_out_channels']
    per = cfg['layers_per_block']
    total = 0
    hh, ww = h, w
    for i, cross in enumerate(cfg['down_cross']):
        if cross:
            total += per * (attn(1, hh * ww, hh * ww, ch[i]) +
                            attn(1, hh * ww, ctx_len, ch[i]))
        if i < len(ch) - 1:
            hh, ww = -(-hh // 2), -(-ww // 2)
    total += attn(1, hh * ww, hh * ww, ch[-1]) + attn(1, hh * ww, ctx_len,
                                                      ch[-1])
    for i, cross in enumerate(reversed(cfg['down_cross'])):
        c = ch[len(ch) - 1 - i]
        if cross:
            total += (per + 1) * (attn(1, hh * ww, hh * ww, c) +
                                  attn(1, hh * ww, ctx_len, c))
        if i < len(ch) - 1:
            hh, ww = hh * 2, ww * 2
    return rows * total


def clip_attention(cfg, sequences=1, length=77):
    return sequences * cfg['layers'] * attn(1, length, length, cfg['width'])


def backward(forward, attention):
    """Forward plus the input-gradient backward of frozen weights: each
    product once more for the inputs' gradient, attention's twice (dQ, dK,
    dV and dP)."""
    return 2 * forward + attention


# ----------------------------------------------------------- rooflines
def least_s(flops, nbytes):
    return max(flops / PEAK_FLOPS, nbytes / PEAK_BYTES)


def self_attention_layers(cfg, h, w):
    """(tokens, width) of every UNet self-attention, in layer order."""
    ch = cfg['block_out_channels']
    per = cfg['layers_per_block']
    out = []
    hh, ww = h, w
    for i, cross in enumerate(cfg['down_cross']):
        if cross:
            out += [(hh * ww, ch[i])] * per
        if i < len(ch) - 1:
            hh, ww = -(-hh // 2), -(-ww // 2)
    out.append((hh * ww, ch[-1]))
    for i, cross in enumerate(reversed(cfg['down_cross'])):
        if cross:
            out += [(hh * ww, ch[len(ch) - 1 - i])] * (per + 1)
        if i < len(ch) - 1:
            hh, ww = hh * 2, ww * 2
    return out


def self_attention_work(cfg, h, w, rows, min_keys):
    """[(flops, bytes)] of each UNet self-attention core with at least
    `min_keys` tokens in one forward: bf16 q, k, v read, o written."""
    return [(attn(rows, s, s, c), 4 * rows * s * c * BF16)
            for s, c in self_attention_layers(cfg, h, w) if s >= min_keys]


def flash_work(cfg, h, w, rows, min_keys):
    """[(flops, bytes)] of each flash attention forward and backward of a
    training step, at the self-attentions of `min_keys` tokens or more.
    Forward: QKᵀ and PV; q, k, v read, o and the fp32 log-sum-exp written.
    Backward: dV, dP, dQ and dK; q, k, v, o, dO and the log-sum-exp read,
    dq, dk and dv written (bf16)."""
    heads = cfg['attention_heads']
    out = []
    for s, c in self_attention_layers(cfg, h, w):
        if s < min_keys:
            continue
        act, lse = rows * s * c * BF16, rows * heads * s * 4
        out.append((attn(rows, s, s, c), 4 * act + lse))
        out.append((2 * attn(rows, s, s, c), 8 * act + lse))
    return out


def vae_mid_attention_work(cfg, h, w, rows):
    """(flops, bytes) of the decoder's mid-block attention processor: the
    q, k, v and out projections with biases and the one-head core."""
    c = cfg['block_out_channels'][-1]
    s = h * w
    flops = 4 * 2 * rows * s * c * c + attn(rows, s, s, c)
    nbytes = (2 * rows * s * c + 4 * c * c + 4 * c) * BF16
    return flops, nbytes

