"""The rest of the port's ED-LoRA tuning workflow against the JAX package,
on the CPU at tiny sizes: the validation prompt set, the grids, the
validation sweep, convert_edlora, train-state checkpoints and resume, the
train CLI with validation during saves, and the test_edlora alpha sweep.

Tolerances:
  * PromptDataset, file names, composed grids, token registration and the
    concept table: exact;
  * visual_validation with fp32 pipelines on the same weights and latents:
    1 uint8 level (the pixel goldens' 2e-3 of [0, 1] rounds to at most 1);
  * convert_edlora's merged weights in fp32: atol 1e-6, rtol 1e-5 (the
    same product summed in another order); alpha 0 leaves them bitwise;
  * train-state save/load and resume: bitwise;
  * the train CLI's losses with validation on and off: bitwise.
    These two rely on the one CPU thread of every port test file
    (tests/torch_port_threads.py): the CPU backward is not
    run-to-run reproducible with several threads (two identical fresh runs
    of the tiny trainer differ in their gradients after one backward);
    forward passes are;
  * test_edlora, port vs JAX, both in bf16 (the shipped test configs'
    precision): at most BF16_SWEEP_MAX uint8 levels anywhere and
    BF16_SWEEP_MEAN on average over each image. Measured on this input: 16
    and 1.88 (under 0.5 % of the pixels more than 4 levels apart). Both
    packages run the UNet and the VAE in bf16 but round in other places
    (the port's attention twins round q·scale and P to bf16 as the Hopper
    kernels do; XLA fuses and keeps some products in fp32). The LoRA
    itself moves these images by a mean of 3.9-4.6 levels (alpha 0 against
    1), over the mean bound, which the test also checks.
"""
import argparse
import importlib.util
import json
import os
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from PIL import Image

import torch_port_threads  # noqa: F401  (one torch thread)
from mixofshow_tpu.convert import diffusers_export as jexport
from mixofshow_tpu.convert import diffusers_import as jimport
from mixofshow_tpu.convert.convert_edlora import convert_edlora as jconvert
from mixofshow_tpu.convert.delta_io import load_edlora_delta as jload_delta
from mixofshow_tpu.data import PromptDataset as JPromptDataset
from mixofshow_tpu.parallel import make_mesh
from mixofshow_tpu.pipelines import EDLoRAPipeline as JPipeline
from mixofshow_tpu.pipelines import init_concepts as jinit
from mixofshow_tpu.pipelines.validation import \
    visual_validation as jvisual_validation
from mixofshow_tpu.text import CLIPTokenizer as JTokenizer
from mixofshow_tpu.utils import vis as jvis
from mixofshow_tpu.zoo import load_models as jload_models
from mixofshow_tpu.zoo import tiny_configs as jax_tiny_configs
from mixofshow_tpu_torch import test_edlora, train_edlora, zoo
from mixofshow_tpu_torch.convert import (convert_edlora, convert_edlora_delta,
                                         load_edlora_delta, load_jax_params,
                                         save_edlora_delta,
                                         state_dict_from_jax)
from mixofshow_tpu_torch.convert.diffusers_export import diffusers_config
from mixofshow_tpu_torch.data import PromptDataset
from mixofshow_tpu_torch.models import AutoencoderKL, CLIPTextModel, UNet
from mixofshow_tpu_torch.models.lora import flatten_lora, init_lora_tree
from mixofshow_tpu_torch.pipelines import (EDLoRAPipeline,
                                           bind_concept_prompt, init_concepts)
from mixofshow_tpu_torch.pipelines.trainer_edlora import (EDLoRATrainer,
                                                          make_optimizer)
from mixofshow_tpu_torch.pipelines.validation import visual_validation
from mixofshow_tpu_torch.text import CLIPTokenizer
from mixofshow_tpu_torch.utils import vis
from mixofshow_tpu_torch.utils.checkpoint import (load_train_state,
                                                  save_train_state,
                                                  train_state_dict)
from test_cli_e2e import SMOKE_YML

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TRAIN_YML = os.path.join(REPO, 'options/train/EDLoRA/real/'
                         'EDLoRA_hermione_B4_Repeat500.yml')
U, C, V = zoo.tiny_configs()
U_J, C_J, V_J = jax_tiny_configs()
BF16_SWEEP_MAX = 20
BF16_SWEEP_MEAN = 2.5
PROMPTS = ['a photo of <a1> <a2>', '<a1> <a2> on a beach, best quality',
           'a painting of <a1> <a2>']


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope='module')
def jax_bundle():
    return jload_models('random:tiny', seed=0)


def _port_modules(b):
    return (load_jax_params(UNet(U, 'cpu'), b.unet),
            load_jax_params(CLIPTextModel(C, 'cpu'), b.text_encoder),
            load_jax_params(AutoencoderKL(V, 'cpu'), b.vae))


def _pngs(root):
    return {f: np.asarray(Image.open(os.path.join(root, f)))
            for f in sorted(os.listdir(root)) if f.endswith('.png')}


def _gap(got, want):
    """(largest, largest per-image mean) uint8 difference over same-named
    PNGs; the names must be the same."""
    assert list(got) == list(want) and got
    diffs = [np.abs(got[f].astype(int) - want[f].astype(int)) for f in got]
    return max(int(d.max()) for d in diffs), max(d.mean() for d in diffs)


# ------------------------------------------------------------ prompt set
@pytest.mark.parametrize('share', [True, False])
def test_prompt_dataset_matches_jax(share):
    """The shipped validation set (hermione, 8 prompts x 8 samples): prompts,
    indices and latents bitwise, under one random.seed."""
    cfg = yaml.safe_load(open(TRAIN_YML))['datasets']['val_vis']
    cfg['prompts'] = os.path.join(REPO, cfg['prompts'])
    cfg['share_latent_across_prompt'] = share
    items = []
    for cls in (JPromptDataset, PromptDataset):
        random.seed(5)
        ds = cls(cfg)
        items.append([ds[i] for i in range(len(ds))])
    assert len(items[0]) == len(items[1]) == 64
    for a, b in zip(*items):
        assert (a['prompts'], a['indices']) == (b['prompts'], b['indices'])
        assert a['latents'].dtype == b['latents'].dtype == np.float32
        np.testing.assert_array_equal(a['latents'], b['latents'])
    assert items[1][0]['prompts'] == 'photo of a <hermione1> <hermione2>'
    lat = [it['latents'] for it in items[1]]
    assert np.array_equal(lat[0], lat[1]) == share


def test_vis_helpers_match_jax(tmp_path):
    """safe_filename gives the same strings; compose_visualize the same
    grid, decoded."""
    for text in ['a photo of <a1> <a2>, best quality!',
                 'path/with:colons*and?', 'x' * 150, 'ünïcode <tok> 7.5']:
        assert vis.safe_filename(text) == jvis.safe_filename(text)
    grids = []
    for name, mod in (('jax', jvis), ('port', vis)):
        d = tmp_path / name / 'Alpha-1.0'
        for p in PROMPTS[:2]:
            for idx in (1, 2):
                arr = np.random.default_rng(idx + len(p)).uniform(
                    size=(48, 48, 3)).astype(np.float32)
                mod.pil_imwrite(mod.array_to_pil(arr), str(
                    d / f'{mod.safe_filename(p)}---G_7.5_S_2---'
                    f'{idx:02d}.png'))
        grids.append(mod.compose_visualize(str(d)))
    assert [os.path.relpath(g, tmp_path / n) for g, n in
            zip(grids, ('jax', 'port'))] == ['Alpha-1.0---composed.jpg'] * 2
    a, b = (np.asarray(Image.open(g)) for g in grids)
    assert a.shape == (16 + 2 * 48, 2 * 48, 3)
    np.testing.assert_array_equal(a, b)


# ------------------------------------------------------- validation sweep
def test_visual_validation_matches_jax(tmp_path, jax_bundle):
    """fp32 tiny pipelines on the same weights and latents, 2 steps, 3
    prompts x 2 samples in batches of 4 (the last one ragged): the same file
    names, pixels within 1 uint8 level."""
    b = jax_bundle
    base = np.asarray(b.text_encoder['token_embedding'])
    opt = {'val': {'compose_visualize': True,
                   'sample': {'num_inference_steps': 2,
                              'guidance_scale': 7.5}},
           'datasets': {'val_vis': {
               'prompts': PROMPTS, 'num_samples_per_prompt': 2,
               'latent_size': [4, 8, 8], 'batch_size_per_gpu': 4}}}
    jtok = JTokenizer()
    jcfg, jtab = jinit(jtok, '<a1>+<a2>', None, base)
    jpipe = JPipeline(b.unet, b.text_encoder, b.vae, tokenizer=jtok,
                      unet_config=U_J, text_config=C_J, vae_config=V_J,
                      new_concept_cfg=jcfg, concept_embedding=jtab,
                      dtype=jnp.float32)
    tok = CLIPTokenizer()
    cfg, table = init_concepts(tok, '<a1>+<a2>', None, base)
    pipe = EDLoRAPipeline(*_port_modules(b), tok, 'cpu', torch.float32,
                          new_concept_cfg=cfg, concept_embedding=table)
    out = {}
    for name, fn, p, ds in (
            ('jax', jvisual_validation, jpipe, JPromptDataset),
            ('port', visual_validation, pipe, PromptDataset)):
        o = dict(opt, path={'visualization': str(tmp_path / name)})
        grid = fn(p, ds(opt['datasets']['val_vis']), 'Iters-1_Alpha-1.0', o)
        assert grid == str(tmp_path / name / 'Iters-1_Alpha-1.0---composed'
                                               '.jpg')
        out[name] = _pngs(tmp_path / name / 'Iters-1_Alpha-1.0')
    assert len(out['port']) == 6
    assert 'a photo of <a1> <a2>---G_7.5_S_2---02.png' in out['port']
    assert _gap(out['port'], out['jax'])[0] <= 1


# --------------------------------------------------------- convert_edlora
def _write_delta(path, te, unet, seed=7):
    """A trained-looking delta for concepts <a1> and <a2>: rank-4 LoRA on
    the text attention and UNet attn1/attn2 with non-zero ups."""
    rng = np.random.default_rng(seed)
    tl = init_lora_tree(rng, te, lambda p: '/attn/' in p)
    ul = init_lora_tree(rng, unet,
                        lambda p: '/attn1/' in p or '/attn2/' in p)
    for leaf in [*flatten_lora(tl).values(), *flatten_lora(ul).values()]:
        leaf['up'] = torch.from_numpy(rng.normal(
            0, 0.05, tuple(leaf['up'].shape)).astype(np.float32))
    emb = {n: torch.from_numpy(rng.normal(0, 0.02, (16, C.width))
                               .astype(np.float32)) for n in ('<a1>', '<a2>')}
    save_edlora_delta(str(path), {'new_concept_embedding': emb,
                                  'text_lora': tl, 'unet_lora': ul})


@pytest.mark.parametrize('alpha', [0.0, 0.7])
def test_convert_edlora_matches_jax(tmp_path, jax_bundle, alpha):
    b = jax_bundle
    unet, te, _ = _port_modules(b)
    _write_delta(tmp_path / 'd.pth', te, unet)
    jtok, tok = JTokenizer(), CLIPTokenizer()
    jte, junet, jcfg, jtab = jconvert(
        b.text_encoder, b.unet, jtok,
        jimport.convert_edlora_delta(jload_delta(str(tmp_path / 'd.pth'))),
        alpha=alpha)
    te2, unet2, cfg, table = convert_edlora(
        te, unet, tok,
        convert_edlora_delta(load_edlora_delta(str(tmp_path / 'd.pth'))),
        alpha=alpha)
    assert te2 is te and unet2 is unet
    assert cfg == jcfg and cfg['<a2>']['concept_token_names'][0] == '<new16>'
    assert tok.added_tokens == jtok.added_tokens
    np.testing.assert_array_equal(table.numpy(), np.asarray(jtab))
    base_unet, base_te, _ = _port_modules(b)
    for mod, jtree, base in ((te, jte, base_te), (unet, junet, base_unet)):
        want = state_dict_from_jax(_np(jtree))
        got, before = mod.state_dict(), base.state_dict()
        moved = 0
        for k, v in got.items():
            if alpha == 0:
                assert torch.equal(v, before[k]), k
            np.testing.assert_allclose(v.numpy(), want[k].numpy(),
                                       atol=1e-6, rtol=1e-5, err_msg=k)
            moved += not torch.equal(v, before[k])
        assert moved == (0 if alpha == 0 else
                         {id(te): 8, id(unet): 128}[id(mod)])


# ------------------------------------------------------ train state/resume
def _tiny_trainer(threshold):
    b = zoo.load_models('random:tiny', 'cpu', seed=0)
    return EDLoRATrainer(
        b.unet, b.text_encoder, b.vae, CLIPTokenizer(), 'cpu', new_concept_token='<a1>+<a2>',
        initializer_token='<rand-0.013>+<rand-0.017>',
        finetune_cfg=yaml.safe_load(open(TRAIN_YML))['models'][
            'finetune_cfg'],
        noise_offset=0.01, attn_reg_weight=0.01, reg_full_identity=False,
        emb_norm_threshold=threshold, compute_dtype=torch.float32)


def _micro_batches(trainer, n):
    """n fixed (batch, draws) pairs at 64x64, batch 1."""
    out = []
    for i in range(n):
        rng = np.random.default_rng(i)
        ids = trainer.tokenizer(bind_concept_prompt(
            [PROMPTS[i % 3]], trainer.new_concept_cfg)).reshape(1, 16, 77)
        pos = [j for j, t in enumerate(ids[0, 0])
               if t in trainer.concept_token_ids][:2]
        masks = np.ones((1, 8, 8, 1), np.float32)
        masks[:, :3] = 0
        batch = {'images': rng.uniform(-1, 1, (1, 64, 64, 3))
                 .astype(np.float32), 'text_ids': ids.astype(np.int32),
                 'masks': masks, 'img_masks': np.ones_like(masks),
                 'concept_pos': np.asarray([pos], np.int32),
                 'concept_pos_mask': np.ones((1, 2), np.float32)}
        out.append((batch, trainer.make_draws(
            1, (8, 8), torch.Generator().manual_seed(100 + i))))
    return out


def _assert_same(a, b, path=''):
    if torch.is_tensor(a):
        assert a.dtype == b.dtype and torch.equal(a, b), path
    elif isinstance(a, dict):
        assert a.keys() == b.keys(), path
        for k in a:
            _assert_same(a[k], b[k], f'{path}/{k}')
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_same(x, y, f'{path}/{i}')
    else:
        assert a == b, path


@pytest.mark.parametrize('accum,threshold', [(1, 0.55), (2, 0.0)])
def test_resume_from_a_train_state_is_exact(tmp_path, accum, threshold):
    """k = 2 updates, save, load into a fresh trainer, m = 1 more: bitwise
    the state of 3 updates in one run (fixed batches, injected draws); the
    saved file round-trips bitwise. threshold 0 freezes the embedding at
    the first micro-step, so the saved flag is True."""
    k, m = 2, 1
    opt_cfg = make_optimizer(_tiny_trainer(threshold).finetune_cfg, 5,
                             grad_accum=accum)

    def run(trainer, state, micro):
        for batch, draws in micro:
            trainer.train_step(state, batch, draws=draws)
        return state

    one = _tiny_trainer(threshold)
    micro = _micro_batches(one, (k + m) * accum)
    whole = run(one, one.init_state(opt_cfg), micro)

    first = _tiny_trainer(threshold)
    state = run(first, first.init_state(opt_cfg), micro[:k * accum])
    path = save_train_state(str(tmp_path / 'train_state-2.pt'), state)
    saved = train_state_dict(state)
    _assert_same(torch.load(path, weights_only=True), saved)
    assert saved['step'] == k * accum and saved['grad_accum'] == accum
    assert bool(saved['emb_frozen']) == (threshold == 0)
    assert saved['lr_schedule']['last_epoch'] == k

    second = _tiny_trainer(threshold)
    fresh = second.init_state(opt_cfg)
    emb = fresh.trainable['concept_embedding']
    loaded = load_train_state(path, fresh)
    assert loaded.trainable['concept_embedding'] is emb
    assert loaded.optimizer.param_groups[0]['params'][0] is emb
    _assert_same(train_state_dict(loaded), saved)
    run(second, loaded, micro[k * accum:])
    _assert_same(train_state_dict(loaded), train_state_dict(whole))

    bad = _tiny_trainer(threshold).init_state(make_optimizer(
        one.finetune_cfg, 5, grad_accum=accum + 1))
    with pytest.raises(ValueError, match='grad_accum'):
        load_train_state(path, bad)


# ----------------------------------------------------------------- CLIs
def _assets(root, val_during_save):
    """test_cli_e2e's tiny workflow: 2 images of one concept, a prompt
    file and SMOKE_YML with a save every step."""
    for d in ('img', 'mask', 'cap'):
        (root / d).mkdir(parents=True)
    rng = np.random.default_rng(0)
    for i in range(2):
        Image.fromarray(rng.integers(0, 255, (96, 80, 3), dtype=np.uint8)
                        ).save(root / 'img' / f'{i}.jpg')
        m = np.zeros((96, 80), np.uint8)
        m[20:70, 15:65] = 255
        Image.fromarray(m).save(root / 'mask' / f'{i}.png')
        (root / 'cap' / f'{i}.txt').write_text('<TOK>, test scene\n')
    (root / 'concept.json').write_text(json.dumps([{
        'instance_prompt': '<TOK>', 'instance_data_dir': 'img',
        'caption_dir': 'cap', 'mask_dir': 'mask'}]))
    (root / 'prompts.txt').write_text('a photo of <TOK>\n<TOK> on a beach\n')
    opt = yaml.safe_load(SMOKE_YML.format(
        val_during_save=str(val_during_save).lower()))
    opt['logger']['save_checkpoint_freq'] = 1
    (root / 'train.yml').write_text(yaml.safe_dump(opt))


def _train(args, report=None):
    steps = []
    train_edlora.main(args + ['--device', 'cpu'], report=report,
                      on_step=lambda i, d: steps.append(
                          (i, {k: v.item() for k, v in d.items()})))
    return steps


def test_train_cli_validates_during_saves_and_resumes(tmp_path, monkeypatch):
    """SMOKE_YML (bf16, 2 steps) with val_during_save and a save every
    step: the deltas, the train states, the PNGs and the grids are written;
    the losses equal those of the same run with validation off, bitwise;
    --resume train_state-1.pt (its experiment archived by the relaunch)
    starts at global step 1 from exactly the saved state."""
    runs = {}
    for val in (False, True):
        root = tmp_path / str(val)
        _assets(root, val)
        monkeypatch.chdir(root)
        runs[val] = _train(['-opt', 'train.yml'])
    assert [s for s, _ in runs[True]] == [0, 1, 2]
    assert runs[True] == runs[False]
    exp = tmp_path / 'True' / 'experiments' / 'e2e_tiny'
    tags = ('1', '2', 'latest')
    assert sorted(os.listdir(exp / 'models')) == sorted(
        [f'edlora_model-{t}.pth' for t in tags] +
        [f'train_state-{t}.pt' for t in tags])
    vis_dir = exp / 'visualization'
    for t in tags:
        assert (vis_dir / f'Iters-{t}_Alpha-1.0---composed.jpg').exists()
        assert sorted(os.listdir(vis_dir / f'Iters-{t}_Alpha-1.0')) == [
            '<a1> <a2> on a beach---G_7.5_S_2---01.png',
            'a photo of <a1> <a2>---G_7.5_S_2---01.png']
    assert not os.listdir(tmp_path / 'False' / 'experiments' / 'e2e_tiny' /
                          'visualization')

    saved = torch.load(exp / 'models' / 'train_state-1.pt',
                       weights_only=True)
    report = {}
    steps = _train(['-opt', 'train.yml', '--resume',
                    'experiments/e2e_tiny/models/train_state-1.pt'], report)
    assert [s for s, _ in steps] == [1, 2]
    assert all(np.isfinite(v) for v in steps[1][1].values())
    _assert_same(report['resumed'], saved)
    assert [s['tag'] for s in report['saves']] == [2, 'latest']
    assert [p.name for p in tmp_path.joinpath('True', 'experiments')
            .iterdir() if '_archived_' in p.name]


def _load_jax_test_cli():
    spec = importlib.util.spec_from_file_location(
        'jax_test_edlora', os.path.join(REPO, 'test_edlora.py'))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_test_edlora_matches_jax(tmp_path, monkeypatch, jax_bundle):
    """The port's test_edlora CLI against the JAX package's test_edlora.test
    on one diffusers-layout directory written by the JAX package's export
    (tiny weights) and one delta, alphas 0 and 1, bf16, 1 step: the same
    file names, pixels within BF16_SWEEP_MAX and BF16_SWEEP_MEAN. The JAX loader assumes
    SD1.5 configs and the JAX CLI shards over every device it sees, so the
    JAX run is given the tiny configs and a one-device mesh."""
    b = jax_bundle
    ckpt = tmp_path / 'ckpt'
    jexport.save_pipeline_params(str(ckpt), unet=_np(b.unet),
                                 vae=_np(b.vae),
                                 text_encoder=_np(b.text_encoder))
    for name, cfg in (('unet', U), ('vae', V), ('text_encoder', C)):
        (ckpt / name / 'config.json').write_text(json.dumps(
            diffusers_config(name, cfg)))
    unet, te, _ = _port_modules(b)
    _write_delta(tmp_path / 'edlora.pth', te, unet)
    (tmp_path / 'prompts.txt').write_text('\n'.join(
        p.replace('<a1> <a2>', '<TOK>') for p in PROMPTS))
    (tmp_path / 'test.yml').write_text(yaml.safe_dump({
        'name': 'tiny_test', 'manual_seed': 0,
        'datasets': {'val_vis': {
            'name': 'PromptDataset', 'prompts': str(tmp_path / 'prompts.txt'),
            'num_samples_per_prompt': 1, 'latent_size': [4, 8, 8],
            'replace_mapping': {'<TOK>': '<a1> <a2>'},
            'batch_size_per_gpu': 2}},
        'models': {'pretrained_path': str(ckpt), 'enable_edlora': True,
                   'new_concept_token': '<a1>+<a2>'},
        'path': {'lora_path': str(tmp_path / 'edlora.pth')},
        'val': {'compose_visualize': True, 'alpha_list': [0, 1.0],
                'sample': {'num_inference_steps': 1,
                           'guidance_scale': 7.5}}}))

    jcli = _load_jax_test_cli()
    monkeypatch.setattr(jimport, 'UNetConfig', lambda: U_J)
    monkeypatch.setattr(jimport, 'VAEConfig', lambda: V_J)
    monkeypatch.setattr(jimport, 'CLIPTextConfig', lambda: C_J)
    monkeypatch.setattr(jcli, 'make_mesh', lambda: make_mesh(1))
    for name in ('jax', 'port'):
        (tmp_path / name).mkdir()
        monkeypatch.chdir(tmp_path / name)
        if name == 'jax':
            jcli.test(argparse.Namespace(opt=str(tmp_path / 'test.yml')))
        else:
            out = test_edlora.main(['-opt', str(tmp_path / 'test.yml'),
                                    '--device', 'cpu'])
            assert sorted(out) == [0, 1.0]
    levels, sweep = {}, {}
    for alpha in ('Alpha-0', 'Alpha-1.0'):
        d = {n: tmp_path / n / 'results' / 'tiny_test' / 'visualization'
             for n in ('jax', 'port')}
        assert (d['port'] / f'{alpha}---composed.jpg').exists()
        got, want = _pngs(d['port'] / alpha), _pngs(d['jax'] / alpha)
        assert len(got) == 3 and all('---G_7.5_S_1---01.png' in f for f in got)
        levels[alpha] = _gap(got, want)
        sweep[alpha] = got
    assert max(m for m, _ in levels.values()) <= BF16_SWEEP_MAX, levels
    assert max(a for _, a in levels.values()) <= BF16_SWEEP_MEAN, levels
    # the mean bound is under the LoRA's own effect on every image
    a0, a1 = sweep['Alpha-0'], sweep['Alpha-1.0']
    assert min(np.abs(a0[f].astype(int) - a1[f].astype(int)).mean()
               for f in a0) > BF16_SWEEP_MEAN
