"""Port parity of the training path at the tiny config, fp32 on the CPU.

The JAX package's weights are carried across with convert.load_jax_params;
the same numpy inputs (and the JAX trainer's own random draws, transposed
NHWC -> NCHW) go through both. Tolerances: whole-graph outputs atol 3e-4 /
rtol 1e-3 as the JAX suite's parity tests; gradients atol 1e-5 + rtol 1e-3
of each group's largest entry (fp32 sums in another order); the
train_losses golden atol 1e-3, its own bound. On the CPU the UNet's large
self-attentions run the flash twins (the JAX package takes its dense XLA
path there); both are the same math.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mixofshow_tpu.convert.delta_io import \
    export_edlora_delta as jexport_delta
from mixofshow_tpu.diffusion import ddpm as jddpm
from mixofshow_tpu.models import layers as jlayers
from mixofshow_tpu.models import lora as jlora
from mixofshow_tpu.models import unet as junet
from mixofshow_tpu.models import vae as jvae
from mixofshow_tpu.models import init_clip_text, init_unet, init_vae
from mixofshow_tpu.pipelines import trainer_edlora as jtr
from mixofshow_tpu.pipelines.concepts import bind_concept_prompt
from mixofshow_tpu.text import CLIPTokenizer as JTokenizer
from mixofshow_tpu_torch import zoo
from mixofshow_tpu_torch.convert import (export_edlora_delta, load_jax_params,
                                         lora_from_jax)
from mixofshow_tpu_torch.diffusion import make_ddpm_schedule
from mixofshow_tpu_torch.models import (AutoencoderKL, CLIPTextModel, UNet,
                                        layers)
from mixofshow_tpu_torch.models.layers import seeded_init_
from mixofshow_tpu_torch.models.lora import (flatten_lora, init_lora_tree,
                                             num_lora_leaves)
from mixofshow_tpu_torch.models.vae import sample_latents
from mixofshow_tpu_torch.pipelines import trainer_edlora as ptr
from mixofshow_tpu_torch.text import CLIPTokenizer

TOL = dict(atol=3e-4, rtol=1e-3)
U, C, V = zoo.tiny_configs()
FINETUNE = {
    'text_embedding': {'enable_tuning': True, 'lr': 1e-3},
    'text_encoder': {'enable_tuning': True, 'lr': 1e-5,
                     'lora_cfg': {'rank': 4, 'alpha': 1.0}},
    'unet': {'enable_tuning': True, 'lr': 1e-4,
             'lora_cfg': {'rank': 4, 'alpha': 1.0}},
}
PROMPT = 'a photo of <g1> <g2> at the beach'


@pytest.fixture(scope='module')
def params():
    return {'unet': init_unet(0, U), 'text': init_clip_text(1, C),
            'vae': init_vae(2, V)}


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _port_modules(p):
    return (load_jax_params(UNet(U, 'cpu'), p['unet']),
            load_jax_params(CLIPTextModel(C, 'cpu'), p['text']),
            load_jax_params(AutoencoderKL(V, 'cpu'), p['vae']))


def _trainers(p, **kw):
    kw = dict(dict(new_concept_token='<g1>+<g2>',
                   initializer_token='<rand-0.013>+<rand-0.017>',
                   finetune_cfg=FINETUNE, attn_reg_weight=0.01,
                   reg_full_identity=False, noise_offset=0.01), **kw)
    jt = jtr.EDLoRATrainer(p['unet'], p['text'], p['vae'],
                           tokenizer=JTokenizer(), unet_config=U,
                           text_config=C, vae_config=V,
                           compute_dtype=jnp.float32, **kw)
    pt = ptr.EDLoRATrainer(*_port_modules(p), CLIPTokenizer(), 'cpu',
                           compute_dtype=torch.float32, **kw)
    return jt, pt


def _batch(trainer, b=1, img=64, seed=0):
    """The tensorized batch the data pipeline emits (JAX layout)."""
    rng = np.random.default_rng(seed)
    bound = bind_concept_prompt([PROMPT] * b, trainer.new_concept_cfg)
    ids = trainer.tokenizer(bound).reshape(b, 16, 77)
    pos = [i for i, t in enumerate(ids[0, 0])
           if t in trainer.concept_token_ids]
    lat = img // 8
    masks = np.ones((b, lat, lat, 1), np.float32)
    masks[:, :lat // 2] = 0
    return {'images': rng.normal(size=(b, img, img, 3)).astype(np.float32),
            'text_ids': ids.astype(np.int32), 'masks': masks,
            'img_masks': np.ones((b, img, img, 1), np.float32),
            'concept_pos': np.asarray([pos] * b, np.int32),
            'concept_pos_mask': np.ones((b, len(pos)), np.float32)}


def _jax_draws(key, b, lat):
    """The JAX trainer's draws for one step (trainer_edlora.py:299-312),
    NCHW."""
    k_vae, k_noise, k_off, k_t = jax.random.split(key, 4)
    shape = (b, lat, lat, 4)
    nchw = (0, 3, 1, 2)
    return {
        'vae_eps': np.asarray(jax.random.normal(k_vae, shape)).transpose(
            nchw),
        'noise': np.asarray(jax.random.normal(k_noise, shape)).transpose(
            nchw),
        'noise_offset': np.asarray(jax.random.normal(
            k_off, (b, 1, 1, 4))).transpose(nchw),
        'timesteps': np.asarray(jax.random.randint(k_t, (b,), 0, 1000))}


def _groups(tree):
    """{'emb': array, 'text': {path: {down, up}}, 'unet': ...} in the
    port's layout, numpy."""
    def f(t):
        return np.asarray(t.detach() if torch.is_tensor(t) else t)
    return {'emb': f(tree['concept_embedding']),
            'text': {k: {n: f(v) for n, v in leaf.items()} for k, leaf in
                     flatten_lora(tree['text_lora']).items()},
            'unet': {k: {n: f(v) for n, v in leaf.items()} for k, leaf in
                     flatten_lora(tree['unet_lora']).items()}}


def _jax_groups(tree):
    """The same from a JAX trainable tree (LoRA leaves transposed)."""
    return _groups({'concept_embedding': np.asarray(tree['concept_embedding']),
                    'text_lora': lora_from_jax(_np(tree['text_lora']), 'cpu'),
                    'unet_lora': lora_from_jax(_np(tree['unet_lora']),
                                               'cpu')})


def _assert_groups_close(got, want, rtol=1e-3, atol=1e-5):
    np.testing.assert_allclose(got['emb'], want['emb'], rtol=0,
                               atol=atol + rtol * np.abs(want['emb']).max())
    for g in ('text', 'unet'):
        assert set(got[g]) == set(want[g])
        scale = max(np.abs(leaf[n]).max() for leaf in want[g].values()
                    for n in ('down', 'up'))
        for path, leaf in want[g].items():
            for n in ('down', 'up'):
                np.testing.assert_allclose(
                    got[g][path][n], leaf[n], rtol=0,
                    atol=atol + rtol * scale, err_msg=f'{g} {path} {n}')


# ------------------------------------------------------------------ modules
def test_ddpm_schedule_matches_jax():
    for pred in ('epsilon', 'v_prediction'):
        js = jddpm.make_ddpm_schedule(prediction_type=pred)
        ps = make_ddpm_schedule(prediction_type=pred)
        for name in ('betas', 'alphas_cumprod', 'sqrt_alphas_cumprod',
                     'sqrt_one_minus_alphas_cumprod'):
            # XLA's fp32 cumprod rounds in another order than torch's
            np.testing.assert_allclose(getattr(ps, name).numpy(),
                                       np.asarray(getattr(js, name)),
                                       atol=1e-5, rtol=0)
        rng = np.random.default_rng(3)
        x = rng.normal(size=(3, 8, 8, 4)).astype(np.float32)
        n = rng.normal(size=(3, 8, 8, 4)).astype(np.float32)
        t = np.asarray([0, 517, 999], np.int32)
        px, pn = (torch.from_numpy(a).permute(0, 3, 1, 2) for a in (x, n))
        pt = torch.from_numpy(t).long()
        for fn in ('add_noise', 'get_velocity', 'target'):
            want = np.asarray(getattr(js, fn)(jnp.asarray(x), jnp.asarray(n),
                                              jnp.asarray(t)))
            got = getattr(ps, fn)(px, pn, pt).permute(0, 2, 3, 1).numpy()
            np.testing.assert_allclose(got, want, atol=2e-5, rtol=0)


@pytest.mark.parametrize('which', ['unet', 'text'])
def test_init_lora_tree_matches_jax(params, which):
    """Same numpy seed, same filter -> the same leaves as the JAX package
    (down transposed to (r, in), up zeros (out, r)), exactly."""
    unet, te, _ = _port_modules(params)
    mod, tree, filt = ((unet, params['unet'],
                        lambda p: '/attn1/' in p or '/attn2/' in p)
                       if which == 'unet' else
                       (te, params['text'], lambda p: '/attn/' in p))
    want = lora_from_jax(_np(jlora.init_lora_tree(
        np.random.default_rng(5), tree, filt, rank=4)), 'cpu')
    got = init_lora_tree(np.random.default_rng(5), mod, filt, rank=4)
    assert num_lora_leaves(got) == num_lora_leaves(want) == \
        (128 if which == 'unet' else 8)
    fw, fg = flatten_lora(want), flatten_lora(got)
    assert set(fg) == set(fw)   # (jax.tree.map sorts dict keys)
    for path in fw:
        for n in ('down', 'up'):
            assert torch.equal(fg[path][n], fw[path][n]), path


def test_vae_encode_matches_jax(params):
    vae = load_jax_params(AutoencoderKL(V, 'cpu'), params['vae'])
    img = np.random.default_rng(4).uniform(-1, 1, (2, 64, 64, 3)) \
        .astype(np.float32)
    jm, jl = jvae.vae_encode(params['vae'], jnp.asarray(img), V)
    with torch.no_grad():
        pm, pl = vae.encode(torch.from_numpy(img).permute(0, 3, 1, 2))
    assert pm.shape == (2, 4, 8, 8)
    np.testing.assert_allclose(pm.permute(0, 2, 3, 1).numpy(),
                               np.asarray(jm), **TOL)
    np.testing.assert_allclose(pl.permute(0, 2, 3, 1).numpy(),
                               np.asarray(jl), **TOL)
    eps = np.random.default_rng(5).normal(size=(2, 4, 8, 8)) \
        .astype(np.float32)
    np.testing.assert_allclose(
        sample_latents(pm, pl, torch.from_numpy(eps)).numpy(),
        pm.numpy() + np.exp(0.5 * pl.numpy()) * eps, atol=1e-6)


def test_zoo_draws_the_decoder_as_before():
    """The encoder and quant_conv register after the decoder, so a seeded
    random VAE draws the decoder and post_quant_conv exactly as the
    decode-only module did."""
    vae = zoo.load_models('random:tiny', 'cpu', seed=6).vae
    ref = torch.nn.Module()
    full = AutoencoderKL(V, 'cpu')
    ref.decoder, ref.post_quant_conv = full.decoder, full.post_quant_conv
    seeded_init_(ref, torch.Generator().manual_seed(6 + 2))
    for name, t in ref.state_dict().items():
        assert torch.equal(vae.state_dict()[name], t), name
    assert {'encoder.conv_in.weight', 'quant_conv.weight'} <= \
        set(vae.state_dict())


def test_sdpa_return_probs_matches_jax():
    rng = np.random.default_rng(6)
    q = rng.normal(size=(2, 64, 2, 16)).astype(np.float32)
    k = rng.normal(size=(2, 77, 2, 16)).astype(np.float32)
    v = rng.normal(size=(2, 77, 2, 16)).astype(np.float32)
    jo, jp = jlayers.sdpa(*map(jnp.asarray, (q, k, v)), return_probs=True)
    po, pp = layers.sdpa(*map(torch.from_numpy, (q, k, v)),
                         return_probs=True)
    assert pp.dtype == torch.float32 and pp.shape == (2, 2, 64, 77)
    np.testing.assert_allclose(po.numpy(), np.asarray(jo), atol=1e-5)
    np.testing.assert_allclose(pp.numpy(), np.asarray(jp), atol=1e-6)


def test_unet_cross_probs_match_jax(params):
    """return_cross_probs with and without prob_columns: the output and the
    (place, layer, probs) list in the JAX order and values."""
    unet = load_jax_params(UNet(U, 'cpu'), params['unet'])
    rng = np.random.default_rng(7)
    x = rng.normal(size=(2, 16, 16, 4)).astype(np.float32)
    ehs = rng.normal(size=(2, 16, 77, 64)).astype(np.float32)
    t = np.asarray([10, 800], np.int32)
    cols = np.asarray([[5, 6], [2, 9]], np.int32)
    labels = []

    def run(p, *args):
        out, aux = junet.unet_apply(p, *args, U, return_cross_probs=True)
        labels[:] = [(a, i) for a, i, _ in aux['cross_probs']]  # at trace
        return out, [pr for _, _, pr in aux['cross_probs']]
    jout, jprobs = jax.jit(run)(params['unet'], jnp.asarray(x),
                                jnp.asarray(t), jnp.asarray(ehs))
    full = [(a, i, np.asarray(p)) for (a, i), p in zip(labels, jprobs)]
    for pc in (None, cols):
        # (the JAX UNet gathers the same columns with take_along_axis)
        jp = full if pc is None else [
            (a, i, np.take_along_axis(p, np.broadcast_to(
                pc[:, None, None, :], (*p.shape[:3], 2)), axis=-1))
            for a, i, p in full]
        with torch.no_grad():
            pout, paux = unet(torch.from_numpy(x).permute(0, 3, 1, 2),
                              torch.from_numpy(t), torch.from_numpy(ehs),
                              return_cross_probs=True,
                              prob_columns=None if pc is None else
                              torch.from_numpy(pc).long())
        np.testing.assert_allclose(pout.permute(0, 2, 3, 1).numpy(),
                                   np.asarray(jout), **TOL)
        pp = paux['cross_probs']
        assert [(a, b) for a, b, _ in pp] == [(a, b) for a, b, _ in jp]
        assert len(pp) == 16
        for (_, _, a), (_, _, b) in zip(pp, jp):
            assert a.shape == b.shape
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5)


def test_unet_remat_gives_identical_grads(params):
    """remat recomputes each transformer in the backward: the same
    gradients, bit for bit, at 32x32 latents (the res-32 self-attentions
    take the flash route)."""
    unet = load_jax_params(UNet(U, 'cpu'), params['unet'])
    unet.requires_grad_(False)
    rng = np.random.default_rng(8)
    x = torch.from_numpy(rng.normal(size=(1, 4, 32, 32)).astype(np.float32))
    ehs = torch.from_numpy(rng.normal(size=(1, 77, 64)).astype(np.float32))
    grads = []
    for remat in (False, True):
        lora = init_lora_tree(np.random.default_rng(2), unet,
                              lambda p: '/attn1/' in p, rank=2)
        for leaf in flatten_lora(lora).values():
            leaf['up'].fill_(0.02)
            for t in leaf.values():
                t.requires_grad_()
        out = unet(x, torch.tensor([500]), ehs, lora, 1.0, remat=remat)
        out.square().mean().backward()
        grads.append({p: (l['down'].grad, l['up'].grad)
                      for p, l in flatten_lora(lora).items()})
    assert grads[0].keys() == grads[1].keys()
    for path in grads[0]:
        for a, b in zip(grads[0][path], grads[1][path]):
            assert a is not None and a.abs().sum() > 0
            assert torch.equal(a, b), path


def test_packed_route_refuses_grad(params):
    """K1 is forward-only: a UNet on the packed route with a LoRA that
    requires grad raises instead of dropping the attn1 gradient."""
    unet = load_jax_params(UNet(U, 'cpu'), params['unet'])
    lora = init_lora_tree(np.random.default_rng(2), unet,
                          lambda p: '/attn1/' in p, rank=2)
    for leaf in flatten_lora(lora).values():
        leaf['down'].requires_grad_()
    x = torch.zeros(1, 4, 32, 32)
    ehs = torch.zeros(1, 77, 64)
    with pytest.raises(RuntimeError, match='forward-only'):
        unet(x, torch.tensor([5]), ehs, lora, fuse_attention='packed')
    with torch.no_grad():
        unet(x, torch.tensor([5]), ehs, lora, fuse_attention='packed')


@pytest.mark.parametrize('full_identity', [False, True])
@pytest.mark.parametrize('presliced', [False, True])
def test_attn_reg_loss_matches_jax(full_identity, presliced):
    rng = np.random.default_rng(9)
    b, h0 = 2, 16
    probs = []
    for i, s in enumerate((1, 2, 4, 8, 4, 2, 1)):
        p = rng.uniform(size=(b, 2, (h0 // s) ** 2, 77)).astype(np.float32)
        probs.append(('down', i, p / p.sum(-1, keepdims=True)))
    pos = np.asarray([[5, 6], [3, 0]], np.int32)
    pos_mask = np.asarray([[1, 1], [1, 0]], np.float32)
    if presliced:
        probs = [(a, i, np.take_along_axis(
            p, np.broadcast_to(pos[:, None, None, :], (*p.shape[:3], 2)),
            axis=-1)) for a, i, p in probs]
    masks = (rng.uniform(size=(b, h0, h0, 1)) > 0.4).astype(np.float32)
    want = jtr.attn_reg_loss([(a, i, jnp.asarray(p)) for a, i, p in probs],
                             jnp.asarray(masks), jnp.asarray(pos),
                             jnp.asarray(pos_mask), 0.01, full_identity,
                             (h0, h0))
    got = ptr.attn_reg_loss([(a, i, torch.from_numpy(p)) for a, i, p in probs],
                            torch.from_numpy(masks),
                            torch.from_numpy(pos).long(),
                            torch.from_numpy(pos_mask), 0.01, full_identity,
                            (h0, h0))
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5,
                               atol=1e-8)


# ------------------------------------------------------------------ trainer
def test_trainer_init_matches_jax(params):
    """The same seed gives the JAX trainer's trainable_init and counts."""
    jt, pt = _trainers(params)
    _assert_groups_close(_groups(pt.trainable_init),
                         _jax_groups(jt.trainable_init), rtol=0, atol=0)
    assert pt.num_text_loras == jt.num_text_loras == 8
    assert pt.num_unet_loras == jt.num_unet_loras == 128
    assert pt.concept_token_ids == jt.concept_token_ids
    assert pt.new_concept_cfg == jt.new_concept_cfg


def test_trainer_loss_and_grads_match_jax(params):
    """loss, loss_attn_reg and the gradients of all three groups, fed the
    JAX trainer's draws, at 256² (32x32 latents: the res-32
    self-attentions take the flash route). The UNet LoRA's up leaves are
    set non-zero so every leaf has a gradient. (The JAX side is jitted:
    eager, its backward takes minutes.)"""
    img = 256
    jt, pt = _trainers(params)
    rng = np.random.default_rng(11)
    jinit = dict(jt.trainable_init)
    jinit['unet_lora'] = jax.tree.map(
        lambda a: jnp.asarray(rng.normal(0, 0.02, a.shape), jnp.float32),
        jinit['unet_lora'])
    batch = _batch(jt, b=1, img=img)
    key = jax.random.PRNGKey(3)
    (jloss, jld), jgrads = jax.jit(
        lambda tr, k, bt, fr: jax.value_and_grad(jt.loss_fn, has_aux=True)(
            tr, k, bt, fr))(jinit, key,
                            {k: jnp.asarray(v) for k, v in batch.items()},
                            jt.frozen_params)

    trainable = {'concept_embedding': torch.from_numpy(
        np.asarray(jinit['concept_embedding'])).requires_grad_(),
        'text_lora': lora_from_jax(_np(jinit['text_lora']), 'cpu'),
        'unet_lora': lora_from_jax(_np(jinit['unet_lora']), 'cpu')}
    for g in ('text_lora', 'unet_lora'):
        for leaf in flatten_lora(trainable[g]).values():
            for t in leaf.values():
                t.requires_grad_()
    loss, ld = pt.loss_fn(trainable, batch,
                          draws=_jax_draws(key, 1, img // 8))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-4)
    np.testing.assert_allclose(ld['loss'].item(), float(jld['loss']),
                               rtol=1e-4)
    np.testing.assert_allclose(ld['loss_attn_reg'].item(),
                               float(jld['loss_attn_reg']), rtol=1e-4)
    got = _groups({'concept_embedding': trainable['concept_embedding'].grad,
                   'text_lora': {k: v for k, v in _grad_tree(
                       trainable['text_lora']).items()},
                   'unet_lora': _grad_tree(trainable['unet_lora'])})
    want = _jax_groups(jgrads)
    assert np.abs(want['emb']).max() > 0
    _assert_groups_close(got, want)


def _grad_tree(tree):
    if set(tree) == {'down', 'up'}:
        return {n: tree[n].grad for n in ('down', 'up')}
    return {k: _grad_tree(v) for k, v in tree.items()}


def test_optimizer_update_matches_optax():
    """One update per group against optax's adamw under the JAX
    make_optimizer, and the lr factor at updates 0-3 against optax's
    linear_schedule."""
    ft = dict(FINETUNE, text_embedding={'enable_tuning': True, 'lr': 1e-3,
                                        'weight_decay': 0.0})
    rng = np.random.default_rng(12)
    p0 = {'concept_embedding': rng.normal(size=(4, 8)).astype(np.float32),
          'text_lora': {'a': {'down': rng.normal(size=(8, 2)).astype(
              np.float32), 'up': rng.normal(size=(2, 8)).astype(np.float32)}},
          'unet_lora': {'b': {'down': rng.normal(size=(8, 2)).astype(
              np.float32), 'up': rng.normal(size=(2, 6)).astype(np.float32)}}}
    grads = [jax.tree.map(lambda a: rng.normal(size=a.shape).astype(
        np.float32), p0) for _ in range(3)]
    jopt = jtr.make_optimizer(ft, total_steps=4)
    jstate, jp = jopt.init(p0), p0
    for g in grads:
        upd, jstate = jopt.update(g, jstate, jp)
        jp = optax.apply_updates(jp, upd)

    def port(tree):
        return {'concept_embedding': torch.from_numpy(
            tree['concept_embedding'].copy()),
            'text_lora': lora_from_jax(tree['text_lora'], 'cpu'),
            'unet_lora': lora_from_jax(tree['unet_lora'], 'cpu')}
    trainable = port(p0)
    for t in [trainable['concept_embedding']] + [
            x for g in ('text_lora', 'unet_lora')
            for leaf in flatten_lora(trainable[g]).values()
            for x in leaf.values()]:
        t.requires_grad_()
    cfg = ptr.make_optimizer(ft, total_steps=4)
    opt, sched = cfg.build(trainable)
    for g in grads:
        pg = port(g)
        trainable['concept_embedding'].grad = pg['concept_embedding']
        for key in ('text_lora', 'unet_lora'):
            for path, leaf in flatten_lora(trainable[key]).items():
                for n in ('down', 'up'):
                    leaf[n].grad = flatten_lora(pg[key])[path][n]
        opt.step()
        sched.step()
    # (a few fp32 ulps: torch divides √v by √(1 − β₂ᵗ), optax takes
    # √(v / (1 − β₂ᵗ)))
    _assert_groups_close(_groups(trainable), _jax_groups(
        jax.tree.map(jnp.asarray, jp)), rtol=0, atol=1e-6)
    sched_j = optax.linear_schedule(1.0, 0.0, 4)
    for n in range(6):
        assert cfg.lr_factor(n) == pytest.approx(float(sched_j(n)))
    assert [g['name'] for g in opt.param_groups] == ['emb', 'text', 'unet']
    assert [g['weight_decay'] for g in opt.param_groups] == [0.0, 0.01, 0.01]


def test_freeze_is_sticky_and_moments_advance(params):
    _, pt = _trainers(params, attn_reg_weight=None)
    cfg = ptr.make_optimizer(FINETUNE, total_steps=10)
    state = pt.init_state(cfg)
    batch = _batch(pt)
    g = torch.Generator().manual_seed(0)
    pt.train_step(state, batch, g)
    assert not bool(state.emb_frozen)
    with torch.no_grad():
        state.trainable['concept_embedding'].fill_(1.0)   # norm 8 >= 0.55
    pt.train_step(state, batch, g)        # the flag is set after this one
    assert bool(state.emb_frozen)
    emb = state.trainable['concept_embedding'].detach().clone()
    unet = {p: l['up'].detach().clone()
            for p, l in flatten_lora(state.trainable['unet_lora']).items()}
    m_before = state.optimizer.state[
        state.trainable['concept_embedding']]['exp_avg'].clone()
    for _ in range(2):
        ld = pt.train_step(state, batch, g)
    assert torch.equal(state.trainable['concept_embedding'], emb)
    assert bool(state.emb_frozen) and ld['Norm_mean'].item() > 0.55
    assert not torch.equal(state.optimizer.state[
        state.trainable['concept_embedding']]['exp_avg'], m_before)
    assert sum((l['up'] - unet[p]).abs().sum().item() for p, l in
               flatten_lora(state.trainable['unet_lora']).items()) > 0


def test_gradient_accumulation_updates_on_the_kth_step(params):
    """k = 2 micro-steps: nothing moves on the first; the update on the
    second is one step on the mean gradient (optax.MultiSteps).

    One CPU thread: multithreaded MKL GEMMs are not bitwise reproducible
    from run to run, and Adam's first step turns those ulps on the
    smallest gradients into ~1e-6 of parameter, the test's own bound."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        _check_gradient_accumulation(params)
    finally:
        torch.set_num_threads(threads)


def _check_gradient_accumulation(params):
    _, pt = _trainers(params, attn_reg_weight=None)
    batch = _batch(pt)
    draws = [{k: torch.as_tensor(v) for k, v in
              _jax_draws(jax.random.PRNGKey(i), 1, 8).items()}
             for i in range(2)]
    state = pt.init_state(ptr.make_optimizer(FINETUNE, 10, grad_accum=2))
    emb0 = state.trainable['concept_embedding'].detach().clone()
    pt.train_step(state, batch, draws=draws[0])
    assert torch.equal(state.trainable['concept_embedding'], emb0)
    pt.train_step(state, batch, draws=draws[1])
    assert state.step == 2 and state.lr_schedule.last_epoch == 1

    # the mean of the two micro-steps' gradients, summed in .grad as
    # separate backward passes (one backward of the summed loss would add
    # the branches inside the shared encoders, in another fp32 order)
    ref = pt.init_state(ptr.make_optimizer(FINETUNE, 10))
    for d in draws:
        loss, _ = pt.loss_fn(ref.trainable, batch, draws=d)
        (loss / 2).backward()
    ref.optimizer.step()
    np.testing.assert_allclose(
        state.trainable['concept_embedding'].detach().numpy(),
        ref.trainable['concept_embedding'].detach().numpy(), atol=1e-6)
    assert not torch.equal(state.trainable['concept_embedding'], emb0)


def test_train_losses_golden(params):
    """tests/goldens/train_losses.npy (tools/gen_goldens.train_losses): two
    steps from the JAX trainer's trainable_init carried over with
    lora_from_jax, fed the JAX draws of PRNGKey(0) and PRNGKey(1); loss and
    Norm_mean per step, atol 1e-3."""
    import os
    from mixofshow_tpu.zoo import tiny_configs
    ucfg, ccfg, vcfg = tiny_configs()
    p = {'unet': init_unet(0, ucfg), 'text': init_clip_text(1, ccfg),
         'vae': init_vae(2, vcfg)}
    jt, pt = _trainers(p)
    state = pt.init_state(ptr.make_optimizer(FINETUNE, total_steps=4))
    with torch.no_grad():
        ji = jt.trainable_init
        state.trainable['concept_embedding'].copy_(
            torch.from_numpy(np.asarray(ji['concept_embedding'])))
        for key in ('text_lora', 'unet_lora'):
            src = flatten_lora(lora_from_jax(_np(ji[key]), 'cpu'))
            for path, leaf in flatten_lora(state.trainable[key]).items():
                for n in ('down', 'up'):
                    leaf[n].copy_(src[path][n])
    batch = dict(_batch(jt, b=1, img=64), masks=np.ones((1, 8, 8, 1),
                                                         np.float32))
    out = []
    for i in range(2):
        ld = pt.train_step(state, batch,
                           draws=_jax_draws(jax.random.PRNGKey(i), 1, 8))
        out += [ld['loss'].item(), ld['Norm_mean'].item()]
    want = np.load(os.path.join(os.path.dirname(__file__), 'goldens',
                                'train_losses.npy'))
    np.testing.assert_allclose(np.asarray(out, np.float32), want, atol=1e-3)


def test_delta_export_matches_jax_and_reloads(params):
    """delta_state_dict -> export_edlora_delta gives the JAX export's keys
    and values; load_delta_state_dict restores a fresh state."""
    jt, pt = _trainers(params)
    cfg = ptr.make_optimizer(FINETUNE, total_steps=4)
    state = pt.init_state(cfg)
    rng = np.random.default_rng(13)
    with torch.no_grad():
        for t in [state.trainable['concept_embedding']] + [
                x for g in ('text_lora', 'unet_lora')
                for leaf in flatten_lora(state.trainable[g]).values()
                for x in leaf.values()]:
            t.copy_(torch.from_numpy(rng.normal(size=t.shape).astype(
                np.float32)))
    delta = pt.delta_state_dict(state)
    assert set(delta['new_concept_embedding']) == {'<g1>', '<g2>'}
    assert delta['new_concept_embedding']['<g1>'].shape == (16, 64)

    def to_jax(tree):
        if set(tree) == {'down', 'up'}:
            return {n: tree[n].numpy().T for n in ('down', 'up')}
        return {k: to_jax(v) for k, v in tree.items()}
    jdelta = {'new_concept_embedding': {
        k: v.numpy() for k, v in delta['new_concept_embedding'].items()},
        'text_lora': to_jax(delta['text_lora']),
        'unet_lora': to_jax(delta['unet_lora'])}
    want = jexport_delta(jdelta)
    got = export_edlora_delta(delta)
    for group in ('new_concept_embedding', 'text_encoder', 'unet'):
        assert set(got[group]) == set(want[group]), group
        for key, val in want[group].items():
            np.testing.assert_array_equal(got[group][key].numpy(), val)
    assert len(got['unet']) == 2 * 128 and len(got['text_encoder']) == 2 * 8

    fresh = pt.init_state(cfg)
    pt.load_delta_state_dict(fresh, delta)
    _assert_groups_close(_groups(fresh.trainable), _groups(state.trainable),
                         rtol=0, atol=0)
