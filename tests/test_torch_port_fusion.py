"""Port parity of gradient fusion and its checkpoint I/O on the CPU, fp32.

The same numpy inputs, the same delta files and the JAX package's weights
(carried across with convert.load_jax_params) go through the JAX package
and the port. Tolerances:
  * solved kernels: 1e-5 (solver cases) and 1e-3 (fusion phases) of the
    layer's largest |ΔW| = |W − W₀|, not of |W|: a wrong solve must not hide
    under W₀. Eigenvectors are never compared, only W. The spatial phase's
    grams at 64² have eigenvalues spread continuously through the rank_tol
    cutoff; fp32 eigensolvers keep or drop the ones within an ulp of e_max
    of it differently (XLA's and torch's differ by up to 1.6e-2 of max|ΔW|
    on the same input grams, and a float64 solve sides with torch), so the
    spatial kernels are compared by what they compute on the captured
    features: ops.solve.output_difference, ‖X(W − W_jax)‖ / ‖X(W_jax −
    W₀)‖, within 1e-3;
  * LBFGS against the exact solve 5e-2, the JAX suite's bound;
  * grams 1e-4 of each gram's largest entry (fp32 sums in another order);
  * checkpoint I/O exactly.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import safetensors.numpy
import safetensors.torch
import torch

from mixofshow_tpu.convert import delta_io as jdelta_io
from mixofshow_tpu.convert import diffusers_export as jexport
from mixofshow_tpu.convert import diffusers_import as jimport
from mixofshow_tpu.fusion import gradient_fusion as jgf
from mixofshow_tpu.models import init_clip_text, init_unet, init_vae
from mixofshow_tpu.models import lora as jlora
from mixofshow_tpu.models.clip import clip_text_encode
from mixofshow_tpu.models.unet import unet_apply
from mixofshow_tpu.ops import solve as jsolve
from mixofshow_tpu.pipelines.concepts import bind_concept_prompt
from mixofshow_tpu.text import CLIPTokenizer as JTokenizer
from mixofshow_tpu.zoo import tiny_configs as jax_tiny_configs
from mixofshow_tpu_torch import gradient_fusion as pcli
from mixofshow_tpu_torch import zoo
from mixofshow_tpu_torch.convert.diffusers_export import diffusers_config
from mixofshow_tpu_torch.convert import (convert_edlora_delta,
                                         load_edlora_delta, load_jax_params,
                                         load_pipeline_params, lora_from_jax,
                                         safetensors_io, save_edlora_delta,
                                         save_pipeline_params)
from mixofshow_tpu_torch.fusion import gradient_fusion as pgf
from mixofshow_tpu_torch.models import (AutoencoderKL, CLIPTextModel, UNet,
                                        unet as punet)
from mixofshow_tpu_torch.models.lora import flatten_lora, init_lora_tree
from mixofshow_tpu_torch.ops import solve as psolve
from mixofshow_tpu_torch.pipelines import EDLoRAPipeline, init_concepts
from mixofshow_tpu_torch.text import CLIPTokenizer

U, C, V = zoo.tiny_configs()
U_J, C_J, V_J = jax_tiny_configs()
CONCEPTS = [('<a1>', '<a2>'), ('<b1>', '<b2>')]
PHASE_TOL = 1e-3


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _rel(got, want, anchor=None):
    """max|got − want| relative to max|want − anchor| (|ΔW|) or max|want|."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = np.abs(want - (0 if anchor is None else
                           np.asarray(anchor, np.float64))).max()
    assert scale > 0
    return np.abs(got - want).max() / scale


# ------------------------------------------------------------------ solver
def _case(name):
    r = np.random.default_rng(['overdetermined', 'underdetermined',
                               'multi_concept', 'group', 'gram_mask']
                              .index(name))
    if name == 'overdetermined':
        x = r.normal(size=(200, 16)).astype(np.float32)
        w0 = np.zeros((16, 8), np.float32)
        wt = r.normal(size=(16, 8)).astype(np.float32)
        g = x.T @ x
        return [g], [g @ (wt - w0)], [w0], 1e-6
    if name == 'underdetermined':
        x = r.normal(size=(3, 32)).astype(np.float32)
        w0 = r.normal(size=(32, 4)).astype(np.float32)
        wt = r.normal(size=(32, 4)).astype(np.float32)
        g = x.T @ x
        return [g], [g @ (wt - w0)], [w0], 1e-6
    if name == 'multi_concept':
        x = r.normal(size=(100, 8)).astype(np.float32)
        g = x.T @ x
        wa, wb = (r.normal(size=(8, 4)).astype(np.float32) for _ in '12')
        return [2 * g], [g @ wa + g @ wb], [np.zeros((8, 4), np.float32)], \
            1e-6
    grams, deltas, anchors = [], [], []
    for f, o in [(8, 8), (16, 4), (8, 8)]:
        x = r.normal(size=(50, f)).astype(np.float32)
        w = r.normal(size=(f, o)).astype(np.float32)
        grams.append(x.T @ x)
        deltas.append(grams[-1] @ w)
        anchors.append(r.normal(size=(f, o)).astype(np.float32))
    return grams, deltas, anchors, 1e-4


@pytest.mark.parametrize('name', ['overdetermined', 'underdetermined',
                                  'multi_concept', 'group', 'gram_mask'])
def test_solver_matches_jax(name):
    """The JAX suite's five solver cases through both packages."""
    if name == 'gram_mask':
        r = np.random.default_rng(3)
        x = r.normal(size=(2, 5, 4)).astype(np.float32)
        mask = np.array([[1, 1, 0, 0, 0], [1, 0, 0, 0, 0]], np.float32)
        want = np.asarray(jsolve.gram(jnp.asarray(x), jnp.asarray(mask)))
        got = psolve.gram(_t(x), _t(mask)).numpy()
        assert _rel(got, want) <= 1e-5
        return
    grams, deltas, anchors, lam = _case(name)
    want, wres = jsolve.solve_layer_group(grams, deltas, anchors, lam=lam,
                                          with_residuals=True)
    got, gres = psolve.solve_layer_group(
        [_t(g) for g in grams], [_t(d) for d in deltas],
        [_t(a) for a in anchors], lam=lam, with_residuals=True)
    assert [tuple(g.shape) for g in got] == [w.shape for w in want]
    for g, w, a in zip(got, want, anchors):
        assert _rel(g.numpy(), w, a) <= 1e-5
    np.testing.assert_allclose(gres, wres, rtol=1e-4)


def test_lbfgs_path_matches_exact():
    """torch.optim.LBFGS (strong Wolfe) reaches the exact solve."""
    r = np.random.default_rng(7)
    x = r.normal(size=(100, 16)).astype(np.float32)
    g = x.T @ x
    w0 = r.normal(size=(16, 8)).astype(np.float32)
    d = g @ (r.normal(size=(16, 8)).astype(np.float32) - w0)
    args = ([_t(g)], [_t(d)], [_t(w0)])
    exact = psolve.solve_layer_group(*args, method='exact')[0]
    lbfgs = psolve.solve_layer_group(*args, method='lbfgs', iters=100)[0]
    np.testing.assert_allclose(lbfgs.numpy(), exact.numpy(), atol=5e-2,
                               rtol=5e-2)


# ---------------------------------------------------------- checkpoint I/O
ARRAYS = {'f32': np.random.default_rng(0).normal(size=(3, 5)).astype('f4'),
          'f16': np.random.default_rng(1).normal(size=(7,)).astype('f2'),
          'i64': np.arange(-3, 9, dtype=np.int64).reshape(2, 2, 3),
          'scalar': np.array(2.5, np.float32)}


@pytest.mark.parametrize('direction', ['port_writes', 'port_reads'])
def test_safetensors_io_matches_the_package(tmp_path, direction):
    path = str(tmp_path / 'x.safetensors')
    bf16 = torch.randn(4, 6, generator=torch.Generator().manual_seed(0)) \
        .to(torch.bfloat16)
    tensors = {k: torch.from_numpy(v) for k, v in ARRAYS.items()}
    tensors['bf16'] = bf16
    if direction == 'port_writes':
        safetensors_io.save_file(tensors, path)
        got_np = safetensors.numpy.load_file(path)
        got_bf16 = safetensors.torch.load_file(path)['bf16']
    else:
        safetensors.torch.save_file(tensors, path)
        got = safetensors_io.load_file(path)
        got_np = {k: v.numpy() for k, v in got.items() if k != 'bf16'}
        got_bf16 = got['bf16']
    for k, v in ARRAYS.items():
        assert got_np[k].dtype == v.dtype and got_np[k].shape == v.shape
        np.testing.assert_array_equal(got_np[k], v)
    assert torch.equal(got_bf16, bf16)


def _jax_delta(seed, tokens):
    """A JAX-layout delta with non-zero ups on the text attention and the
    UNet attn1/attn2 linears (the reference finetune_cfg's layers)."""
    rng = np.random.default_rng(seed)
    te, un = init_clip_text(1, C_J), init_unet(0, U_J)
    tl = jlora.init_lora_tree(rng, te, lambda p: '/attn/' in p)
    ul = jlora.init_lora_tree(rng, un, lambda p: '/attn1/' in p or
                              '/attn2/' in p)
    bump = lambda t: jax.tree.map(  # noqa: E731
        lambda a: np.asarray(a) + 0.02 * rng.normal(size=a.shape)
        .astype(np.float32), t)
    emb = {tok: (0.02 * rng.normal(size=(16, C.width))).astype(np.float32)
           for tok in tokens}
    return {'new_concept_embedding': emb, 'text_lora': bump(_np(tl)),
            'unet_lora': bump(_np(ul))}


def _same_lora(got, want_jax):
    want = flatten_lora(lora_from_jax(want_jax, 'cpu'))
    got = flatten_lora(got)
    assert set(got) == set(want)
    for p in want:
        for n in ('down', 'up'):
            assert torch.equal(got[p][n], want[p][n]), p


@pytest.mark.parametrize('saver', ['jax', 'port'])
def test_delta_load_and_convert_match_jax(tmp_path, saver):
    """A delta saved by either package reads back through the port's
    load_edlora_delta + convert_edlora_delta as the same LoRA as the JAX
    package's convert_edlora_delta gives (carried across by
    lora_from_jax)."""
    delta = _jax_delta(3, ['<a1>', '<a2>'])
    path = str(tmp_path / 'd.pth')
    if saver == 'jax':
        jdelta_io.save_edlora_delta(path, delta)
    else:
        save_edlora_delta(path, {
            'new_concept_embedding': {k: _t(v) for k, v in
                                      delta['new_concept_embedding'].items()},
            'text_lora': lora_from_jax(delta['text_lora'], 'cpu'),
            'unet_lora': lora_from_jax(delta['unet_lora'], 'cpu')})
    want = jimport.convert_edlora_delta(jdelta_io.load_edlora_delta(path))
    got = convert_edlora_delta(load_edlora_delta(path))
    for key in ('text_lora', 'unet_lora'):
        _same_lora(got[key], want[key])
        _same_lora(got[key], delta[key])
    assert set(got['new_concept_embedding']) == {'<a1>', '<a2>'}
    for k, v in want['new_concept_embedding'].items():
        np.testing.assert_array_equal(got['new_concept_embedding'][k].numpy(),
                                      v)


@pytest.fixture(scope='module')
def base():
    return _np({'unet': init_unet(0, U_J), 'text': init_clip_text(1, C_J),
                'vae': init_vae(2, V_J)})


def _port_modules(p):
    return (load_jax_params(UNet(U, 'cpu'), p['unet']),
            load_jax_params(AutoencoderKL(V, 'cpu'), p['vae']),
            load_jax_params(CLIPTextModel(C, 'cpu'), p['text']))


def _assert_trees_equal(got, want, path=''):
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            _assert_trees_equal(got[k], want[k], f'{path}/{k}')
    elif isinstance(want, list):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_trees_equal(g, w, f'{path}/{i}')
    else:
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want),
                                      err_msg=path)


def test_port_export_reads_back_in_jax(tmp_path, base):
    """The port's save_pipeline_params, read by the JAX package's loader,
    gives back exactly the JAX trees the port was loaded from."""
    unet, vae, te = _port_modules(base)
    save_pipeline_params(str(tmp_path), unet, vae, te, {'<a1>': {}})
    for sub, conv, cfg, key in (('unet', jimport.convert_unet, U_J, 'unet'),
                                ('vae', jimport.convert_vae, V_J, 'vae'),
                                ('text_encoder', jimport.convert_clip_text,
                                 C_J, 'text')):
        sd = jimport.load_state_dict(jimport._find_weights(
            str(tmp_path / sub)))
        _assert_trees_equal(conv(sd, cfg), base[key], sub)
    assert json.loads((tmp_path / 'new_concept_cfg.json').read_text()) == \
        {'<a1>': {}}


def _write_configs(root):
    """The JAX export writes no config.json (its loader assumes SD1.5); a
    diffusers directory has one per model."""
    for name, cfg in (('unet', U), ('vae', V), ('text_encoder', C)):
        (root / name / 'config.json').write_text(json.dumps(
            diffusers_config(name, cfg)))


def _assert_modules_equal(got, base):
    for name, want in zip(('unet', 'vae', 'text_encoder'),
                          _port_modules(base)):
        a, b = got[name].state_dict(), want.state_dict()
        assert a.keys() == b.keys()
        for k in a:
            assert torch.equal(a[k], b[k]), f'{name}.{k}'


def test_jax_export_loads_in_port(tmp_path, base):
    """The JAX package's export, read by the port's loader, equals
    load_jax_params of the same trees."""
    jexport.save_pipeline_params(str(tmp_path), unet=base['unet'],
                                 vae=base['vae'], text_encoder=base['text'])
    _write_configs(tmp_path)
    _assert_modules_equal(load_pipeline_params(str(tmp_path), 'cpu'), base)


def test_loader_reads_bin_files_and_legacy_vae_names(tmp_path, base):
    """torch pickles (.bin, a 'state_dict' entry unwrapped) and the older
    diffusers VAE attention (query/key/value/proj_attn as 4-dim 1x1 convs,
    'norm'), as the JAX loader takes them."""
    sds = {'unet': jexport.export_unet(base['unet']),
           'vae': jexport.export_vae(base['vae']),
           'text_encoder': jexport.export_clip_text(base['text'])}
    legacy = {'to_q': 'query', 'to_k': 'key', 'to_v': 'value',
              'to_out.0': 'proj_attn', 'group_norm': 'norm'}
    vae = {}
    for k, v in sds['vae'].items():
        for new, old in legacy.items():
            tag = f'attentions.0.{new}.'
            if tag in k:
                k = k.replace(tag, f'attentions.0.{old}.')
                v = v[:, :, None, None] if v.ndim == 2 else v
        vae[k] = v
    sds['vae'] = vae
    for name, sd in sds.items():
        (tmp_path / name).mkdir()
        file = 'diffusion_pytorch_model.bin' if name != 'text_encoder' \
            else 'pytorch_model.bin'
        torch.save({'state_dict': {k: _t(v) for k, v in sd.items()}},
                   tmp_path / name / file)
    _write_configs(tmp_path)
    _assert_modules_equal(load_pipeline_params(str(tmp_path), 'cpu'), base)


# ------------------------------------------------------------ gram capture
def test_clip_gram_capture_matches_jax(base):
    tok = JTokenizer()
    tok.add_tokens([f'<new{i}>' for i in range(32)])
    prompts = bind_concept_prompt(['a photo of <c>'], {'<c>': {
        'concept_token_names': [f'<new{i}>' for i in range(16)]}})[:4] + \
        ['<new20> <new21> walking']
    ids = np.asarray(tok(prompts))
    mask = (np.arange(77)[None] <= (ids == 49407).argmax(1)[:, None])
    rng = np.random.default_rng(4)
    table = (0.02 * rng.normal(size=(32, C.width))).astype(np.float32)
    jl = _np(jlora.init_lora_tree(rng, base['text'],
                                  lambda p: '/attn/' in p))
    jl = jax.tree.map(lambda a: a + 0.05, jl)
    _, want = clip_text_encode(base['text'], jnp.asarray(ids), C_J,
                               concept_embedding=jnp.asarray(table), lora=jl,
                               lora_alpha=0.7, capture_grams=True,
                               token_mask=jnp.asarray(mask))
    te = load_jax_params(CLIPTextModel(C, 'cpu'), base['text'])
    with torch.no_grad():
        _, got = te(torch.from_numpy(ids.astype(np.int64)), _t(table),
                    lora_from_jax(jl, 'cpu'), 0.7, capture_grams=True,
                    token_mask=torch.from_numpy(mask))
    assert len(got) == len(want) == C.layers
    for g, w in zip(got, want):
        assert set(g) == set(w) == {'qkv', 'out', 'fc1', 'fc2'}
        for k in w:
            assert _rel(g[k].numpy(), w[k]) <= 1e-4, k


def test_unet_gram_capture_matches_jax(base):
    rng = np.random.default_rng(6)
    x = rng.normal(size=(1, 8, 8, 4)).astype(np.float32)
    ehs = rng.normal(size=(1, 16, 77, C.width)).astype(np.float32)
    jl = _np(jlora.init_lora_tree(rng, base['unet'], lambda p: True))
    jl = jax.tree.map(lambda a: a + 0.02, jl)
    # jitted: op-by-op dispatch of the capturing UNet takes ~3x longer
    _, aux = jax.jit(lambda p, x, e, lora: unet_apply(
        p, x, jnp.asarray([500]), e, U_J, lora=lora, lora_alpha=1.0,
        capture_grams=punet.ALL_GRAM_POINTS))(
            base['unet'], jnp.asarray(x), jnp.asarray(ehs), jl)
    unet = load_jax_params(UNet(U, 'cpu'), base['unet'])
    with torch.no_grad():
        _, got = unet(_t(x).permute(0, 3, 1, 2), torch.tensor([500]),
                      _t(ehs), lora_from_jax(jl, 'cpu'),
                      capture_grams=punet.ALL_GRAM_POINTS)
    want = aux['grams']
    assert set(got['grams']) == set(want) == set(range(16))
    for idx, w in want.items():
        g = got['grams'][idx]
        assert set(g) == set(w) == set(punet.ALL_GRAM_POINTS)
        for k in w:
            assert _rel(g[k].numpy(), w[k]) <= 1e-4, (idx, k)


# ---------------------------------------------------------- fusion phases
@pytest.fixture(scope='module')
def concept_cfg(tmp_path_factory):
    d = tmp_path_factory.mktemp('concepts')
    cfg = []
    for i, (a, b) in enumerate(CONCEPTS):
        path = str(d / f'{i}.pth')
        jdelta_io.save_edlora_delta(path, _jax_delta(10 + i, [a, b]))
        cfg.append({'lora_path': path, 'unet_alpha': 1.0,
                    'text_encoder_alpha': 0.8, 'concept_name': f'{a} {b}'})
    path = d / 'concepts.json'
    path.write_text(json.dumps(cfg))
    return str(path)


@pytest.fixture(scope='module')
def phases(base, concept_cfg):
    """Phases 1-4 through both packages: each phase from the previous
    phase's merged weights, the JAX spatial draws handed to the port."""
    jparsed, clist = jgf.parse_new_concepts(concept_cfg)
    jtok = JTokenizer()
    jcfg, jtable = jgf.merge_new_concepts(jparsed, clist, jtok)
    jtext, jt = jgf.merge_text_encoder(jparsed, clist, jcfg, jtok,
                                       base['text'], jtable, C_J)
    junet, jkv = jgf.merge_kv_in_cross_attention(
        jparsed, clist, jcfg, jtok, jtext, C_J, jtable, base['unet'], U_J)
    _, jsp = jgf.merge_spatial_attention(
        jparsed, clist, jcfg, jtok, jtext, C_J, jtable, junet, U_J,
        num_inference_steps=2, record_nums=2, image_size=64, seed=0,
        compute_dtype=jnp.float32)
    draws = [np.asarray(jax.random.normal(jax.random.PRNGKey(ci),
                                          (1, 8, 8, 4), jnp.float32))
             for ci in range(len(clist))]

    pparsed, _ = pgf.parse_new_concepts(concept_cfg, 'cpu')
    ptok = CLIPTokenizer()
    pcfg, ptable = pgf.merge_new_concepts(pparsed, clist, ptok)
    unet = load_jax_params(UNet(U, 'cpu'), base['unet'])
    te = load_jax_params(CLIPTextModel(C, 'cpu'), base['text'])
    pt = pgf.merge_text_encoder(pparsed, clist, pcfg, ptok, te, ptable)
    pkv = pgf.merge_kv_in_cross_attention(pparsed, clist, pcfg, ptok, te,
                                          ptable, unet)
    psp = pgf.merge_spatial_attention(
        pparsed, clist, pcfg, ptok, te, ptable, unet, num_inference_steps=2,
        record_nums=2, image_size=64, compute_dtype=torch.float32,
        latents=[_t(d).permute(0, 3, 1, 2) for d in draws])
    return {'cfg': (jcfg, pcfg), 'table': (jtable, ptable),
            'text': (jt, pt, base['text']), 'crosskv': (jkv, pkv,
                                                        base['unet']),
            'spatial': (_np(jsp), psp, junet)}


def test_category_embedding_matches_jax(base):
    """The concept rows and the first eos of one bound prompt, through the
    text encoder with a concept table."""
    tok, jtok = CLIPTokenizer(), JTokenizer()
    names = [f'<new{i}>' for i in range(16)]
    for t in (tok, jtok):
        t.add_tokens(names)
    ids = np.asarray(tok([f'photo of a {names[3]} dog']))[0]
    assert (ids == np.asarray(jtok([f'photo of a {names[3]} dog']))[0]).all()
    table = (0.02 * np.random.default_rng(8).normal(size=(16, C.width))) \
        .astype(np.float32)
    want = jgf.category_embedding(base['text'], C_J, table, ids)
    te = load_jax_params(CLIPTextModel(C, 'cpu'), base['text'])
    got = pgf.category_embedding(te, _t(table), ids)
    assert got.shape == want.shape == (2, C.width)
    np.testing.assert_allclose(got.numpy(), want, atol=3e-4, rtol=1e-3)


def test_merge_new_concepts_matches_jax(phases):
    (jcfg, pcfg), (jtable, ptable) = phases['cfg'], phases['table']
    assert pcfg == jcfg
    assert pcfg['<b2>']['concept_token_ids'] == list(range(49456, 49472))
    np.testing.assert_array_equal(ptable.numpy(), jtable)


def _phase_error(got, want, anchor, g, phase):
    if phase != 'spatial':
        return _rel(got.numpy(), want, anchor)
    return psolve.output_difference(got, _t(want), _t(anchor), g)


@pytest.mark.parametrize('phase,n_layers', [('text', 8), ('crosskv', 32),
                                            ('spatial', 96)])
def test_fusion_phase_matches_jax(phases, phase, n_layers):
    """Each phase's solved (in, out) kernels within 1e-3 of the layer's
    max|ΔW| (see the module docstring for the spatial phase)."""
    want, (got, _, grams), anchor_tree = phases[phase]
    assert set(got) == set(want) and len(got) == n_layers
    for path, w in want.items():
        anchor = np.asarray(jlora.get_path(anchor_tree, path)['kernel'])
        anchor = anchor.reshape(-1, anchor.shape[-1])
        err = _phase_error(got[path], np.asarray(w), anchor, grams[path],
                           phase)
        assert err <= PHASE_TOL, (path, err)


def test_spatial_phase_covers_ff_and_proj(base):
    """Phase 4 solves the reference's full candidate list (ff.net.*,
    proj_in, proj_out with 4-dim 1x1-conv LoRA weights, attn1) as the JAX
    package does, with the kernels written back in the right layout."""
    r = np.random.default_rng(5)
    c0 = U.block_out_channels[0]
    inner = 4 * c0
    prefix = 'down_blocks.0.attentions.0'

    def pair(i, o, conv=False):
        tail = (1, 1) if conv else ()
        return {'lora_down.weight': 0.1 * r.normal(size=(4, i) + tail)
                .astype('f'),
                'lora_up.weight': 0.1 * r.normal(size=(o, 4) + tail)
                .astype('f')}

    mods = {f'{prefix}.transformer_blocks.0.ff.net.0.proj':
            pair(c0, 2 * inner),
            f'{prefix}.transformer_blocks.0.ff.net.2': pair(inner, c0),
            f'{prefix}.proj_in': pair(c0, c0, conv=True),
            f'{prefix}.proj_out': pair(c0, c0, conv=True),
            f'{prefix}.transformer_blocks.0.attn1.to_q': pair(c0, c0)}
    unet_delta = {f'{m}.{k}': v for m, p in mods.items()
                  for k, v in p.items()}
    emb = {'<z1>': 0.01 * r.normal(size=(16, C.width)).astype('f')}
    delta = {'params': {'new_concept_embedding': emb, 'text_encoder': {},
                        'unet': unet_delta}}
    expected = {'down_blocks/0/attentions/0/ff/proj',
                'down_blocks/0/attentions/0/ff/out',
                'down_blocks/0/attentions/0/proj_in',
                'down_blocks/0/attentions/0/proj_out',
                'down_blocks/0/attentions/0/attn1/to_q'}
    clist = [{'lora_path': 'inline', 'concept_name': '<z1>',
              'unet_alpha': 1.0}]

    jout = jimport.convert_edlora_delta(delta)
    jparsed = [{'embedding': jout['new_concept_embedding'], 'text_lora': {},
                'unet_crosskv': {}, 'unet_spatial': jout['unet_lora']}]
    jtok = JTokenizer()
    jcfg, jtable = jgf.merge_new_concepts(jparsed, clist, jtok)
    _, want = jgf.merge_spatial_attention(
        jparsed, clist, jcfg, jtok, base['text'], C_J, jtable, base['unet'],
        U_J, num_inference_steps=2, record_nums=2, image_size=64,
        compute_dtype=jnp.float32)

    pout = convert_edlora_delta(delta)
    assert set(flatten_lora(pout['unet_lora'])) == expected
    pparsed = [{'embedding': pout['new_concept_embedding'], 'text_lora': {},
                'unet_crosskv': {}, 'unet_spatial': pout['unet_lora']}]
    ptok = CLIPTokenizer()
    pcfg, ptable = pgf.merge_new_concepts(pparsed, clist, ptok)
    unet = load_jax_params(UNet(U, 'cpu'), base['unet'])
    te = load_jax_params(CLIPTextModel(C, 'cpu'), base['text'])
    old = {p: pgf.layer_kernel(unet, p).clone() for p in expected}
    draws = [_t(np.asarray(jax.random.normal(jax.random.PRNGKey(0),
                                             (1, 8, 8, 4)))).permute(
        0, 3, 1, 2)]
    got, _, grams = pgf.merge_spatial_attention(
        pparsed, clist, pcfg, ptok, te, ptable, unet, num_inference_steps=2,
        record_nums=2, image_size=64, compute_dtype=torch.float32,
        latents=draws)
    assert set(got) == set(want) == expected
    for p in expected:
        new = pgf.layer_kernel(unet, p)
        assert torch.equal(new, got[p])      # written back in (out, in)
        assert not torch.allclose(new, old[p], atol=1e-7), p
        err = psolve.output_difference(got[p], _t(np.asarray(want[p])),
                                       old[p], grams[p])
        assert err <= PHASE_TOL, (p, err)


# ------------------------------------------------------------- end to end
def test_fusion_cli_end_to_end(tmp_path):
    """python -m mixofshow_tpu_torch.gradient_fusion on random:tiny with the
    port's own deltas: the directory reloads with the grown vocabulary and
    samples."""
    b = zoo.load_models('random:tiny', 'cpu')
    cfg = []
    for i, (a, c) in enumerate(CONCEPTS):
        rng = np.random.default_rng(20 + i)
        _, table = init_concepts(CLIPTokenizer(), f'{a}+{c}', None,
                                 b.text_encoder.token_embedding.weight, rng)
        tl = init_lora_tree(rng, b.text_encoder, lambda p: '/attn/' in p)
        ul = init_lora_tree(rng, b.unet,
                            lambda p: '/attn1/' in p or '/attn2/' in p)
        for leaf in [*flatten_lora(tl).values(), *flatten_lora(ul).values()]:
            leaf['up'] += 0.01
        path = str(tmp_path / f'{i}.pth')
        save_edlora_delta(path, {'new_concept_embedding': {
            a: _t(table[:16]), c: _t(table[16:])}, 'text_lora': tl,
            'unet_lora': ul})
        cfg.append({'lora_path': path, 'unet_alpha': 1.0,
                    'text_encoder_alpha': 1.0, 'concept_name': f'{a} {c}'})
    (tmp_path / 'c.json').write_text(json.dumps(cfg))
    report = {}
    ckpt, new_cfg = pcli.main([
        '--concept_cfg', str(tmp_path / 'c.json'), '--save_path',
        str(tmp_path / 'out'), '--pretrained_models', 'random:tiny',
        '--spatial_steps', '2', '--image_size', '64', '--device', 'cpu'],
        report=report)
    assert {k: len(report[k]['kernels']) for k in
            ('text', 'crosskv', 'spatial')} == {'text': 8, 'crosskv': 32,
                                                'spatial': 96}
    assert all(np.isfinite(v) for k in ('text', 'crosskv', 'spatial')
               for v in report[k]['residuals'].values())
    log = (tmp_path / 'out' / 'combined_model_base.log').read_text()
    assert 'unet spatial' in log and 'fused checkpoint saved' in log
    fused = zoo.load_models(ckpt, 'cpu')
    assert fused.text_encoder.cfg.vocab_size == 49408 + 64
    assert len(fused.tokenizer) == 49408 + 64
    with open(os.path.join(ckpt, 'new_concept_cfg.json')) as f:
        assert json.load(f) == new_cfg
    moved = (fused.unet.mid.attention.attn2.to_k.weight -
             b.unet.mid.attention.attn2.to_k.weight).abs().max()
    assert moved > 0
    pipe = EDLoRAPipeline(fused.unet, fused.text_encoder, fused.vae,
                          fused.tokenizer, 'cpu', torch.float32,
                          new_concept_cfg=new_cfg)
    img = pipe('a photo of <a1> <a2> and <b1> <b2>', height=64, width=64,
               num_inference_steps=2, output_type='np')
    img = np.asarray(img)
    assert img.shape == (1, 64, 64, 3) and np.isfinite(img).all()


def test_load_models_rejects_a_partial_checkpoint(tmp_path):
    b = zoo.load_models('random:tiny', 'cpu')
    save_pipeline_params(str(tmp_path), unet=b.unet)
    with pytest.raises(FileNotFoundError, match='lacks'):
        zoo.load_models(str(tmp_path), 'cpu')
