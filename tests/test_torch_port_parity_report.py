"""tools/port_parity_check.py against tools/parity_check.py, and the port's
CLIP against transformers, on the CPU.

The parity report: one tiny diffusers directory (the JAX package's
random:tiny weights written by the port's exporter) and one seeded ED-LoRA
delta; the JAX tool emits its fp32 outputs (in process, the JAX loader
given the tiny configs, which it would otherwise take to be SD1.5's), and
the port's tool compares with them in `--pretrained` and `--delta` modes at
2 steps: it passes at `--max-tol 2e-3` (the goldens' atol) and fails, with
exit code 1, when its delta is applied at alpha 0.5 against JAX's 1.0.

CLIP: a random-init `transformers.CLIPTextModel` built from a config (never
`from_pretrained`), loaded into the port's CLIPTextModel through
`diffusers_import.load_into`: last_hidden_state within atol 2e-4, rtol 1e-3,
as tests/test_torch_parity.py holds the JAX package.
"""
import dataclasses
import json
import sys

import numpy as np
import pytest
import torch

from mixofshow_tpu.convert import diffusers_import as jimport
from mixofshow_tpu.zoo import load_models as jload
from mixofshow_tpu.zoo import tiny_configs as jax_tiny_configs
from mixofshow_tpu_torch import zoo
from mixofshow_tpu_torch.convert import (load_jax_params, save_edlora_delta,
                                         save_pipeline_params)
from mixofshow_tpu_torch.convert.diffusers_import import load_into
from mixofshow_tpu_torch.models import (AutoencoderKL, CLIPTextConfig,
                                        CLIPTextModel, UNet)
from mixofshow_tpu_torch.models.lora import flatten_lora, init_lora_tree

sys.path.insert(0, 'tools')
import parity_check  # noqa: E402
import port_parity_check  # noqa: E402

PROMPTS = ['a photo of a dog', 'a castle on a hill']
DELTA_PROMPTS = ['a <a1> <a2> in the forest', 'a photo of <a1> <a2>']
BASE = ['--steps', '2', '--guidance', '4.0', '--height', '64', '--width',
        '64', '--batch', '2', '--model-size', 'tiny']


@pytest.fixture(scope='module')
def ckpt(tmp_path_factory):
    root = tmp_path_factory.mktemp('parity')
    b = jload('random:tiny', seed=0)
    u, c, v = zoo.tiny_configs()
    unet = load_jax_params(UNet(u, 'cpu'), b.unet)
    te = load_jax_params(CLIPTextModel(c, 'cpu'), b.text_encoder)
    save_pipeline_params(str(root / 'sd'), unet,
                         load_jax_params(AutoencoderKL(v, 'cpu'), b.vae), te)
    rng = np.random.default_rng(7)
    tl = init_lora_tree(rng, te, lambda p: '/attn/' in p)
    ul = init_lora_tree(rng, unet, lambda p: '/attn1/' in p or '/attn2/' in p)
    for leaf in [*flatten_lora(tl).values(), *flatten_lora(ul).values()]:
        leaf['up'] = torch.from_numpy(rng.normal(
            0, 0.05, tuple(leaf['up'].shape)).astype(np.float32))
    emb = {n: torch.from_numpy(rng.normal(0, 0.02, (16, c.width))
                               .astype(np.float32)) for n in ('<a1>', '<a2>')}
    save_edlora_delta(str(root / 'delta.pth'), {
        'new_concept_embedding': emb, 'text_lora': tl, 'unet_lora': ul})
    return root


def _json(out):
    return json.loads(out[out.index('{'):])


def _jax_emit(monkeypatch, capsys, argv):
    u, c, v = jax_tiny_configs()
    monkeypatch.setattr(jimport, 'UNetConfig', lambda: u)
    monkeypatch.setattr(jimport, 'VAEConfig', lambda: v)
    monkeypatch.setattr(jimport, 'CLIPTextConfig', lambda: c)
    assert parity_check.main(argv) == 0
    return _json(capsys.readouterr().out)


@pytest.mark.parametrize('mode', ['pretrained', 'delta'])
def test_port_report_against_jax_emit(ckpt, tmp_path, monkeypatch, capsys,
                                      mode):
    src = ['--pretrained', str(ckpt / 'sd')]
    prompts = PROMPTS
    if mode == 'delta':
        src += ['--delta', str(ckpt / 'delta.pth')]
        prompts = DELTA_PROMPTS
    argv = src + BASE + ['--prompts', *prompts]
    emitted = _jax_emit(monkeypatch, capsys,
                        argv + ['--emit', str(tmp_path / 'jax')])
    cmp = argv + ['--ref-dir', str(tmp_path / 'jax'), '--device', 'cpu',
                  '--max-tol', '2e-3']
    rc = port_parity_check.main(cmp)
    rep = _json(capsys.readouterr().out)
    assert [e['name'] for e in rep['images']] == \
        [e['name'] for e in emitted['images']]
    assert rep['images'][0]['name'] == prompts[0].replace(' ', '_') + \
        '---G_4.0_S_2---01'
    assert rc == 0 and rep['summary']['all_pass'], rep
    assert rep['summary']['max_abs'] <= 2e-3
    assert all(e['compared'] and e['ref_format'] == 'npy'
               for e in rep['images'])
    if mode == 'delta':   # a planted change: alpha 0.5 against JAX's 1.0
        rc = port_parity_check.main(cmp + ['--alpha', '0.5'])
        bad = _json(capsys.readouterr().out)
        assert rc == 1 and bad['summary']['fail'] == 2, bad['summary']
        assert bad['summary']['max_abs'] > 2e-3


def test_port_report_emits_and_reads_back(ckpt, tmp_path, capsys):
    argv = ['--pretrained', str(ckpt / 'sd')] + BASE + [
        '--prompts', 'a castle', '--device', 'cpu']
    assert port_parity_check.main(argv + ['--emit', str(tmp_path)]) == 0
    name = _json(capsys.readouterr().out)['images'][0]['name']
    assert np.load(tmp_path / f'{name}.npy').shape == (64, 64, 3)
    assert port_parity_check.main(argv + ['--ref-dir', str(tmp_path)]) == 0
    rep = _json(capsys.readouterr().out)
    assert rep['images'][0]['max_abs'] == 0.0
    (tmp_path / f'{name}.npy').unlink()     # the 8-bit preview is read
    assert port_parity_check.main(argv + ['--ref-dir', str(tmp_path)]) == 0
    assert _json(capsys.readouterr().out)['images'][0]['ref_format'] == 'png'
    with pytest.raises(ValueError, match='--model-size sd15'):
        port_parity_check.main(['--pretrained', str(ckpt / 'sd'),
                                '--prompts', 'x', '--emit', str(tmp_path),
                                '--device', 'cpu'])


def test_clip_text_matches_transformers():
    from transformers import CLIPTextConfig as HFConfig
    from transformers import CLIPTextModel as HFModel
    hf_cfg = HFConfig(vocab_size=1000, hidden_size=64, intermediate_size=128,
                      num_hidden_layers=2, num_attention_heads=2,
                      max_position_embeddings=77, hidden_act='quick_gelu')
    torch.manual_seed(0)
    model = HFModel(hf_cfg).eval()
    ids = torch.from_numpy(np.array([[49406 % 1000, 5, 7, 300, 999] +
                                     [999] * 72,
                                     [1, 2, 3, 4, 5] + [999] * 72], np.int64))
    with torch.no_grad():
        want = model(ids).last_hidden_state
    ours = load_into('text_encoder', CLIPTextModel(dataclasses.replace(
        CLIPTextConfig(), vocab_size=1000, width=64, layers=2, heads=2,
        mlp_dim=128), 'cpu'), model.state_dict()).eval()
    with torch.no_grad():
        got = ours(ids)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=2e-4,
                               rtol=1e-3)
