"""The port's regional CLI and T2I-Adapter converter against the JAX package.

* `convert_t2i_adapter` reads the same seeded state dict in the diffusers
  layout (with and without the `adapter.` prefix) and in the original
  TencentARC layout (1 and 2 resnets a stage); the features of the port's
  T2IAdapter match JAX's `t2i_adapter_apply` (atol 3e-4, rtol 1e-3), and
  `skep` / `down_opt` checkpoints raise in both packages.
* `prepare_text` returns the JAX CLI's tuples on regionally_sample.sh's
  region string and on strings built the same way from every layout file
  under datasets/validation_spatial_condition/ at its condition image's
  size, an empty box and a trailing '|' (the layout readers are
  chip_smoke.py's, which drives the CLI on the card with them).
* The CLI end to end: one tiny fused directory (the JAX package's tiny
  weights written by the port's exporter) and adapter directories in both
  layouts, the same argv to the JAX root CLI and to the port's, a 64x128
  canvas with a box past the lower edge, keypose and sketch, 2 images: the
  same file names and `.txt` files, images within one uint8 level. Both
  runs are set to fp32 and the port is given the JAX CLI's noise (the two
  packages draw different noise for one seed), by patching each CLI's
  `build_model` to fp32 and the port pipeline's `_initial_latents`.
"""
import ast
import dataclasses
import functools
import glob
import importlib.util
import os
import re
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

import torch_port_threads  # noqa: F401  (one torch thread)
from mixofshow_tpu.models import t2i_adapter as jt2i
from mixofshow_tpu.pipelines import init_concepts as jinit
from mixofshow_tpu.text import CLIPTokenizer as JTokenizer
from mixofshow_tpu.zoo import load_models as jload
from mixofshow_tpu_torch import regionally_controlable_sampling as pcli
from mixofshow_tpu_torch import zoo
from mixofshow_tpu_torch.convert import load_jax_params, safetensors_io
from mixofshow_tpu_torch.convert.diffusers_export import save_pipeline_params
from mixofshow_tpu_torch.models import (AutoencoderKL, CLIPTextModel,
                                        T2IAdapter, T2IAdapterConfig, UNet)
from mixofshow_tpu_torch.models.t2i_adapter import convert_t2i_adapter
from mixofshow_tpu_torch.pipelines import RegionallyT2IAdapterPipeline
from chip_smoke import (layout_rewrite, original_layout, read_layout,
                        sample_sh_args)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LAYOUTS = os.path.join(REPO, 'datasets', 'validation_spatial_condition')
GRAPH_TOL = dict(atol=3e-4, rtol=1e-3)
CONCEPTS = '<potter1>+<potter2>+<hermione1>+<hermione2>'
RANDOM_LINE = 'not found — random init'


def _load_jax_cli():
    spec = importlib.util.spec_from_file_location(
        'jax_regional_cli', os.path.join(REPO,
                                         'regionally_controlable_sampling.py'))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# ---------------------------------------------------------------- converter
def _seeded_adapter(cfg_j, seed):
    params = jt2i.init_t2i_adapter(seed, cfg_j)
    cfg = T2IAdapterConfig(in_channels=cfg_j.in_channels,
                           channels=cfg_j.channels,
                           num_res_blocks=cfg_j.num_res_blocks)
    return params, load_jax_params(T2IAdapter(cfg, 'cpu'), params)


@pytest.mark.parametrize('layout,nums_rb', [
    ('diffusers', 1), ('diffusers-prefixed', 1), ('tencentarc', 1),
    ('tencentarc', 2)])
def test_convert_t2i_adapter_matches_jax(layout, nums_rb):
    cfg_j = jt2i.T2IAdapterConfig(in_channels=3, channels=(32, 64, 128, 128),
                                  num_res_blocks=nums_rb)
    _, module = _seeded_adapter(cfg_j, 3)
    sd = {k: v.clone() for k, v in module.state_dict().items()}
    if layout == 'diffusers-prefixed':
        sd = {f'adapter.{k}': v for k, v in sd.items()}
    elif layout == 'tencentarc':
        sd = original_layout(sd, nums_rb)
        assert 'body.1.block1.weight' in sd and not any(
            '.resnets.' in k for k in sd)
    # the converters are told the tiny channels and 1 resnet a stage
    cfg_port = T2IAdapterConfig.tiny(3)
    got = convert_t2i_adapter(sd, cfg_port, 'cpu')
    assert got.cfg.num_res_blocks == nums_rb
    jparams = jt2i.convert_t2i_adapter({k: v.numpy() for k, v in sd.items()},
                                       jt2i.T2IAdapterConfig.tiny(3))
    x = np.random.default_rng(1).uniform(0, 1, (2, 64, 48, 3)).astype(
        np.float32)
    want = jt2i.t2i_adapter_apply(jparams, jnp.asarray(x), cfg_j)
    with torch.no_grad():
        feats = got(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert len(feats) == len(want) == 4
    for f, w in zip(feats, want):
        np.testing.assert_allclose(f.permute(0, 2, 3, 1).numpy(),
                                   np.asarray(w), **GRAPH_TOL)


@pytest.mark.parametrize('bad', ['body.2.skep.weight',
                                 'body.2.down_opt.op.weight'])
def test_convert_t2i_adapter_refuses_what_jax_refuses(bad):
    _, module = _seeded_adapter(jt2i.T2IAdapterConfig.tiny(1), 4)
    sd = original_layout(module.state_dict(), 1)
    sd[bad] = torch.zeros(128, 64, 3, 3)
    word = bad.split('.')[2]
    with pytest.raises(ValueError, match=word):
        jt2i.convert_t2i_adapter({k: v.numpy() for k, v in sd.items()},
                                 jt2i.T2IAdapterConfig.tiny(1))
    with pytest.raises(ValueError, match=word):
        convert_t2i_adapter(sd, T2IAdapterConfig.tiny(1), 'cpu')


def test_convert_t2i_adapter_raises_on_weights_it_cannot_place():
    _, module = _seeded_adapter(jt2i.T2IAdapterConfig.tiny(3), 5)
    sd = dict(module.state_dict())
    del sd['body.1.in_conv.weight']
    with pytest.raises(KeyError, match='body.1.in_conv.weight'):
        convert_t2i_adapter(sd, T2IAdapterConfig.tiny(3), 'cpu')
    with pytest.raises(ValueError, match='conv_in'):   # 1 channel, not 3
        convert_t2i_adapter(module.state_dict(), T2IAdapterConfig.tiny(1),
                            'cpu')


# ------------------------------------------------------------- prepare_text
def _layout_cases():
    cases = []
    for txt in sorted(glob.glob(os.path.join(LAYOUTS, '*', '*.txt')) +
                      glob.glob(os.path.join(LAYOUTS, '*', '*', '*.txt'))):
        stem = txt[:-4]
        cond = [p for p in (stem + '_pose.png', stem + '_sketch.png',
                            stem + '_sketch.jpg') if os.path.exists(p)]
        w, h = Image.open(cond[0]).size
        lay = read_layout(txt)
        cases.append(pytest.param(lay['context_prompt'], layout_rewrite(lay),
                                  h, w, id=os.path.basename(stem)))
    return cases


LAYOUT_CASES = _layout_cases()


def test_every_layout_file_is_a_case():
    assert len(LAYOUT_CASES) == 10


@pytest.mark.parametrize('prompt,rewrite,h,w', LAYOUT_CASES + [
    pytest.param(sample_sh_args()['context_prompt'],
                 sample_sh_args()['prompt_rewrite'], 512, 1024,
                 id='regionally_sample'),
    pytest.param('a lake', '[a <a1>]-*-[]-*-[]|[b]-*-[c]-*-[0, 0, 64, 64]|',
                 64, 128, id='empty-box-trailing-bar'),
    pytest.param('x', '', 512, 512, id='no-regions')])
def test_prepare_text_matches_jax(prompt, rewrite, h, w):
    jcli = _load_jax_cli()
    want = jcli.prepare_text(prompt, rewrite, h, w)
    got = pcli.prepare_text(prompt, rewrite, h, w)
    assert got == want
    assert [type(v) for r in got[1] for v in r[2]] == \
        [type(v) for r in want[1] for v in r[2]]


def test_prepare_text_keeps_boxes_past_the_canvas():
    """regionally_sample.sh's boxes end at pixel 1024 of a 512-high canvas:
    2.0, not clipped (JAX's _box_mask never clips either)."""
    rewrite = sample_sh_args()['prompt_rewrite']
    _, regions = pcli.prepare_text('p', rewrite, 512, 1024)
    assert [r[2][2] for r in regions] == [2.0, 2.0]
    assert regions[0][2] == [12 / 512, 36 / 1024, 2.0, 600 / 1024]


# ------------------------------------------------------------------ the CLI
@pytest.fixture(scope='module')
def fused(tmp_path_factory):
    """A tiny fused directory (JAX's random:tiny weights with four concept
    tokens' rows, written by the port's exporter), a keypose adapter
    directory in the TencentARC layout and a sketch adapter directory in
    the diffusers layout (prefixed, under adapter/), and a 64x128 pose and
    sketch image."""
    root = tmp_path_factory.mktemp('regional_cli')
    b = jload('random:tiny', seed=0)
    u, c, v = zoo.tiny_configs()
    base = np.asarray(b.text_encoder['token_embedding'])
    cfg, table = jinit(JTokenizer(), CONCEPTS, None, base)
    te = dict(b.text_encoder)
    te['token_embedding'] = np.concatenate([base, table])
    pc = dataclasses.replace(c, vocab_size=te['token_embedding'].shape[0])
    save_pipeline_params(
        str(root / 'fused'), load_jax_params(UNet(u, 'cpu'), b.unet),
        load_jax_params(AutoencoderKL(v, 'cpu'), b.vae),
        load_jax_params(CLIPTextModel(pc, 'cpu'), te), cfg)
    _, kp = _seeded_adapter(jt2i.T2IAdapterConfig.tiny(3), 7)
    _, sk = _seeded_adapter(jt2i.T2IAdapterConfig.tiny(1), 8)
    (root / 'keypose').mkdir()
    torch.save(original_layout(kp.state_dict(), 1),
               root / 'keypose' / 'pytorch_model.bin')
    (root / 'sketch' / 'adapter').mkdir(parents=True)
    safetensors_io.save_file(
        {f'adapter.{k}': t for k, t in sk.state_dict().items()},
        str(root / 'sketch' / 'adapter' /
            'diffusion_pytorch_model.safetensors'))
    rng = np.random.default_rng(0)
    pose = np.zeros((64, 128, 3), np.uint8)
    pose[8:56, 10:50] = 255
    pose[20:60, 70:120, 1] = 200
    Image.fromarray(pose).save(root / 'pose.png')
    Image.fromarray(rng.integers(0, 256, (64, 128), np.uint8)).save(
        root / 'sketch.png')
    return root, kp, sk


def _argv(root, out, adapters=True):
    argv = ['--pretrained_model', str(root / 'fused'),
            '--keypose_condition', str(root / 'pose.png'),
            '--sketch_condition', str(root / 'sketch.png'),
            '--keypose_adaptor_weight', '0.9',
            '--region_keypose_adaptor_weight', '[0, 0, 32, 64]-0.5',
            '--sketch_adaptor_weight', '0.6',
            '--prompt', 'two people near a lake',
            '--negative_prompt', 'low quality',
            '--prompt_rewrite',
            '[a <potter1> <potter2>, in a jacket]-*-[blurry]-*-[4, 8, 128, 60]'
            '|[a <hermione1> <hermione2>]-*-[]-*-[10, 64, 60, 124]',
            '--seed', '19', '--suffix', 'wide',
            '--num_inference_steps', '2', '--num_images_per_prompt', '2',
            '--model_size', 'tiny', '--save_dir', str(out)]
    if adapters:
        argv += ['--keypose_adapter_path', str(root / 'keypose'),
                 '--sketch_adapter_path', str(root / 'sketch')]
    else:
        argv += ['--keypose_adapter_path', str(root / 'missing')]
    return argv


def _jax_noise(self, latents, b, h, w, seed):
    lat = np.array(jax.random.normal(jax.random.PRNGKey(seed),
                                       (b, h, w, 4), jnp.float32))
    return torch.from_numpy(lat).permute(0, 3, 1, 2).contiguous().to(
        self.device)


def _run_both(root, tmp_path, monkeypatch, capsys, adapters=True):
    jcli = _load_jax_cli()
    monkeypatch.setattr(jcli, 'build_model', functools.partial(
        jcli.build_model, dtype=jnp.float32))
    monkeypatch.setattr(pcli, 'build_model', functools.partial(
        pcli.build_model, dtype=torch.float32))
    monkeypatch.setattr(RegionallyT2IAdapterPipeline, '_initial_latents',
                        _jax_noise)
    monkeypatch.setattr(sys, 'argv', ['regionally_controlable_sampling.py']
                        + _argv(root, tmp_path / 'jax', adapters))
    jcli.main()
    jout = capsys.readouterr().out
    report = {}
    pcli.main(_argv(root, tmp_path / 'port', adapters) + ['--device', 'cpu'],
              report=report)
    pout = capsys.readouterr().out
    return jout, pout, report


def _files(d):
    return sorted(os.path.relpath(p, d) for p in glob.glob(
        os.path.join(d, '**', '*.*'), recursive=True))


def test_cli_matches_jax_cli(fused, tmp_path, monkeypatch, capsys):
    root, _, _ = fused
    jout, pout, report = _run_both(root, tmp_path, monkeypatch, capsys)
    assert RANDOM_LINE not in jout and RANDOM_LINE not in pout
    jfiles, pfiles = _files(tmp_path / 'jax'), _files(tmp_path / 'port')
    assert pfiles == jfiles and len(pfiles) == 4
    assert all(re.fullmatch(r'seed_19/two_people_near_a_lake---wide---'
                            r'[0-9a-f]{8}---[01]\.(png|txt)', f)
               for f in pfiles)
    imgs = []
    for f in pfiles:
        jp, pp = tmp_path / 'jax' / f, tmp_path / 'port' / f
        if f.endswith('.txt'):
            assert pp.read_text() == jp.read_text()
            continue
        a = np.asarray(Image.open(jp)).astype(int)
        g = np.asarray(Image.open(pp)).astype(int)
        assert g.shape == a.shape == (64, 128, 3)
        assert np.abs(g - a).max() <= 1, f
        imgs.append(g)
    assert not np.array_equal(imgs[0], imgs[1])    # two draws of noise
    assert sorted(os.path.relpath(p, tmp_path / 'port')
                  for p in report['files']) == pfiles[::2]
    assert all(report[k] >= 0 for k in ('load_s', 'sample_s', 'save_s'))


def test_cli_missing_adapter_path_takes_a_random_adapter(fused, tmp_path,
                                                         monkeypatch, capsys):
    """A keypose path that does not exist (and no sketch path): both CLIs
    print the same notice, twice, and sample with seeded random adapters
    (which differ between the packages, so only the names compare)."""
    root, _, _ = fused
    jout, pout, _ = _run_both(root, tmp_path, monkeypatch, capsys,
                              adapters=False)
    jlines = [ln for ln in jout.splitlines() if RANDOM_LINE in ln]
    plines = [ln for ln in pout.splitlines() if RANDOM_LINE in ln]
    assert plines == jlines and len(plines) == 2
    assert _files(tmp_path / 'port') == _files(tmp_path / 'jax')


def test_cli_loads_the_adapters_it_was_given(fused):
    root, kp, sk = fused
    pipe = pcli.build_model(str(root / 'fused'), str(root / 'keypose'),
                            str(root / 'sketch'), device='cpu',
                            dtype=torch.float32, model_size='tiny')
    for got, want in ((pipe.keypose_adapter, kp), (pipe.sketch_adapter, sk)):
        for k, t in want.state_dict().items():
            assert torch.equal(got.state_dict()[k], t), k
    assert len(pipe.tokenizer) == 49408 + 64
    with pytest.raises(FileNotFoundError, match='new_concept_cfg.json'):
        pcli.build_model(str(root / 'keypose'), device='cpu')


def test_cli_defaults_match_jax_cli(monkeypatch):
    jcli = _load_jax_cli()
    monkeypatch.setattr(sys, 'argv', ['x', '--pretrained_model', 'd'])
    want = vars(jcli.parse_args())
    got = vars(pcli.parse_args(['--pretrained_model', 'd']))
    assert got.pop('device') == 'cuda'
    assert got == want


def test_conditions_of_two_sizes_are_refused(fused, tmp_path):
    root, _, _ = fused
    Image.new('L', (64, 64)).save(tmp_path / 'square.png')
    argv = _argv(root, tmp_path)
    argv[argv.index('--sketch_condition') + 1] = str(tmp_path / 'square.png')
    with pytest.raises(ValueError, match='same size'):
        pcli.main(argv + ['--device', 'cpu'])


def test_layout_reader_reads_the_2x_demo():
    lay = read_layout(os.path.join(LAYOUTS, 'multi-characters',
                                   'real_pose_2x',
                                   'potter_hermione_thanos_2x.txt'))
    assert ast.literal_eval(lay['box3']) == [8, 1302, 1016, 1992]
    assert layout_rewrite(lay).count('|') == 2
