"""The port's training data pipeline, options and CLI against the JAX
package's, on the CPU.

The host modules are jax-free copies: under the same Python `random` and
numpy seeds they must give identical outputs (exact equality). The CLI
trains the tiny config for 2 steps at 64x64 and its reference-format delta
loads with the JAX package's `convert_edlora_delta`.
"""
import copy
import json
import os
import random

import numpy as np
import pytest
import torch
import yaml
from PIL import Image

import torch_port_threads  # noqa: F401  (one torch thread)
from mixofshow_tpu.convert.delta_io import load_edlora_delta
from mixofshow_tpu.convert.diffusers_import import convert_edlora_delta
from mixofshow_tpu.data import DataLoader as JLoader
from mixofshow_tpu.data import LoraDataset as JDataset
from mixofshow_tpu.data import TrainBatcher as JBatcher
from mixofshow_tpu.data import build_transform as jbuild
from mixofshow_tpu.data.loader import default_collate as jcollate
from mixofshow_tpu.data.pil_transform import PairCompose as JCompose
from mixofshow_tpu.pipelines.concepts import init_concepts as jinit
from mixofshow_tpu.text import CLIPTokenizer as JTokenizer
from mixofshow_tpu.utils import logging_utils as jlog
from mixofshow_tpu.utils import options as jopts
from mixofshow_tpu_torch import test_edlora, train_edlora
from mixofshow_tpu_torch.data import (DataLoader, LoraDataset, PairCompose,
                                      TrainBatcher, build_transform,
                                      default_collate)
from mixofshow_tpu_torch.models.lora import flatten_lora
from mixofshow_tpu_torch.pipelines.concepts import init_concepts
from mixofshow_tpu_torch.text import CLIPTokenizer
from mixofshow_tpu_torch.utils import logging_utils as plog
from mixofshow_tpu_torch.utils import options as popts
from mixofshow_tpu_torch.utils.registry import Registry

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TRANSFORMS = [
    [{'type': 'HumanResizeCropFinalV3', 'size': 64, 'crop_p': 0.5},
     {'type': 'ToTensor'}, {'type': 'Normalize', 'mean': [0.5], 'std': [0.5]},
     {'type': 'ShuffleCaption', 'keep_token_num': 1},
     {'type': 'EnhanceText', 'enhance_type': 'human'}],
    [{'type': 'ResizeFillMaskNew', 'size': 64, 'crop_p': 0.5,
      'scale_ratio': [0.7, 1.0]},
     {'type': 'ToTensor'}, {'type': 'Normalize', 'mean': [0.5], 'std': [0.5]},
     {'type': 'EnhanceText', 'enhance_type': 'object'}],
    [{'type': 'PairResize', 'size': 72}, {'type': 'PairRandomCrop',
                                          'size': 64},
     {'type': 'PairRandomHorizontalFlip', 'p': 0.5}, {'type': 'ToTensor'}],
    [{'type': 'Resize', 'size': 70}, {'type': 'CenterCrop', 'size': 60},
     {'type': 'RandomCrop', 'size': 48}, {'type': 'RandomHorizontalFlip'},
     {'type': 'ToTensor'}, {'type': 'EnhanceText', 'enhance_type': 'style'}],
]


def _same(a, b):
    if isinstance(a, dict):
        assert set(a) == set(b)
        for k in a:
            _same(a[k], b[k])
    elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    elif isinstance(a, Image.Image):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    else:
        assert a == b


@pytest.mark.parametrize('chain', range(len(TRANSFORMS)))
def test_transforms_match_jax(chain):
    rng = np.random.default_rng(chain)
    for seed in range(4):
        h, w = 80 + 13 * seed, 70 + 29 * (seed % 2)
        img = Image.fromarray(rng.integers(0, 255, (h, w, 3), dtype=np.uint8))
        mask = Image.fromarray(((rng.uniform(size=(h, w)) > 0.5) * 255)
                               .astype(np.uint8))
        outs = []
        for compose, build in ((JCompose, jbuild),
                               (PairCompose, build_transform)):
            random.seed(seed)
            t = compose([build(o) for o in TRANSFORMS[chain]])
            outs.append(t(img, mask=mask,
                          prompts='<a1> <a2>, red hat, on grass, smiling'))
        _same(outs[0][0], outs[1][0])
        _same(outs[0][1], outs[1][1])


def _concept_dir(root, n=3, size=None):
    img_dir, mask_dir, cap_dir = (root / 'img', root / 'mask',
                                  root / 'caption')
    for d in (img_dir, mask_dir, cap_dir):
        d.mkdir()
    rng = np.random.default_rng(0)
    for i in range(n):
        hw = (size, size) if size else (200 + 40 * i, 160)
        Image.fromarray(rng.integers(0, 255, (*hw, 3), dtype=np.uint8)).save(
            img_dir / f'{i}.png')
        m = np.zeros(hw, np.uint8)
        m[hw[0] // 5:hw[0] * 4 // 5, hw[1] // 5:hw[1] * 3 // 4] = 255
        Image.fromarray(m).save(mask_dir / f'{i}.png')
        (cap_dir / f'{i}.txt').write_text(
            f'<TOK>, image number {i}, on grass\n')
    cfg = [{'instance_prompt': '<TOK>', 'instance_data_dir': str(img_dir),
            'caption_dir': str(cap_dir), 'mask_dir': str(mask_dir)}]
    path = root / 'concept.json'
    path.write_text(json.dumps(cfg))
    return str(path)


def test_dataset_loader_and_batcher_match_jax(tmp_path):
    opt = {'concept_list': _concept_dir(tmp_path), 'use_caption': True,
           'use_mask': True, 'replace_mapping': {'<TOK>': '<a1> <a2>'},
           'instance_transform': TRANSFORMS[0], 'dataset_enlarge_ratio': 4}
    base = np.zeros((49408, 32), np.float32)
    batches = []
    for ds_cls, loader_cls, batcher_cls, collate, tok_cls, init in (
            (JDataset, JLoader, JBatcher, jcollate, JTokenizer, jinit),
            (LoraDataset, DataLoader, TrainBatcher, default_collate,
             CLIPTokenizer, init_concepts)):
        random.seed(3)
        ds = ds_cls(opt)
        tok = tok_cls()
        cfg, _ = init(tok, '<a1>+<a2>', None, base)
        batcher = batcher_cls(tok, cfg)
        loader = loader_cls(ds, batch_size=2, seed=5,
                            collate_fn=lambda items, b=batcher: b(
                                collate(items)))
        assert len(ds) == 12 and len(loader) == 6
        batches.append(list(loader))
    assert len(batches[0]) == len(batches[1]) == 6
    for a, b in zip(*batches):
        _same(a, b)
    first = batches[1][0]
    assert first['images'].shape == (2, 64, 64, 3)
    assert first['text_ids'].shape == (2, 16, 77)
    assert first['masks'].shape == (2, 8, 8, 1)
    assert first['concept_pos_mask'].sum() == 4


def test_registry_options_and_logging(tmp_path):
    reg = Registry('t')

    @reg.register()
    class A:
        pass
    assert reg.get('A') is A and 'A' in reg
    with pytest.raises(KeyError):
        reg.register(A)
    with pytest.raises(KeyError, match='No object'):
        reg.get('B')
    yml = os.path.join(REPO, 'options/train/EDLoRA/real/'
                       'EDLoRA_potter_B4_Repeat500.yml')
    po, jo = popts.load_options(yml), jopts.load_options(yml)
    assert po == jo
    assert popts.dict2str(po) == jopts.dict2str(jo)
    for mp, dt in (('fp16', torch.bfloat16), ('bf16', torch.bfloat16),
                   ('no', torch.float32), ('fp32', torch.float32)):
        assert popts.resolve_compute_dtype({'mixed_precision': mp}) == dt
    assert popts.resolve_compute_dtype({}) == torch.bfloat16
    assert plog.reduce_loss_dict({'l': torch.tensor(0.5)}) == \
        jlog.reduce_loss_dict({'l': np.float32(0.5)}) == {'l': 0.5}


def _tiny_yml(tmp_path, **over):
    cfg = {
        'name': 'tiny_cli', 'manual_seed': 0, 'mixed_precision': 'no',
        'datasets': {'train': {
            'name': 'LoraDataset',
            'concept_list': _concept_dir(tmp_path, n=2, size=80),
            'use_caption': True, 'use_mask': True,
            'instance_transform': TRANSFORMS[0],
            'replace_mapping': {'<TOK>': '<c1> <c2>'},
            'batch_size_per_gpu': 1, 'dataset_enlarge_ratio': 1}},
        'models': {
            'pretrained_path': 'random:tiny', 'enable_edlora': True,
            'finetune_cfg': {
                'text_embedding': {'enable_tuning': True, 'lr': 1e-3},
                'text_encoder': {'enable_tuning': True, 'lr': 1e-5,
                                 'lora_cfg': {'rank': 4, 'alpha': 1.0}},
                'unet': {'enable_tuning': True, 'lr': 1e-4,
                         'lora_cfg': {'rank': 4, 'alpha': 1.0}}},
            'new_concept_token': '<c1>+<c2>',
            'initializer_token': '<rand-0.013>+<rand-0.017>',
            'noise_offset': 0.01, 'attn_reg_weight': 0.01,
            'reg_full_identity': False, 'use_mask_loss': True},
        'path': {'experiments_root': str(tmp_path / 'exp')},
        'train': {'optim_g': {'weight_decay': 0.01, 'betas': [0.9, 0.999]},
                  'emb_norm_threshold': 0.55},
        'val': {'val_during_save': False},
        'logger': {'print_freq': 1, 'save_checkpoint_freq': 1},
    }
    for k, v in over.items():
        cfg[k] = dict(cfg[k], **v) if isinstance(v, dict) else v
    path = tmp_path / 'tiny.yml'
    path.write_text(yaml.safe_dump(cfg))
    return str(path)


def test_cli_trains_and_saves_a_reference_delta(tmp_path):
    """2 steps on the CPU; the saved .pth loads with the JAX package's
    convert_edlora_delta and holds the trained leaves."""
    steps = []
    trainer, state, ld = train_edlora.main(
        ['-opt', _tiny_yml(tmp_path), '--device', 'cpu'],
        on_step=lambda i, d: steps.append((i, float(d.get('loss', 0)))))
    assert [i for i, _ in steps] == [0, 1, 2] and state.step == 2
    assert all(np.isfinite(v) for _, v in steps[1:])
    assert np.isfinite(float(ld['loss_attn_reg']))
    models = tmp_path / 'exp' / 'models'
    assert sorted(os.listdir(models)) == [
        'edlora_model-1.pth', 'edlora_model-2.pth', 'edlora_model-latest.pth',
        'train_state-1.pt', 'train_state-2.pt', 'train_state-latest.pt']
    raw = load_edlora_delta(str(models / 'edlora_model-latest.pth'))
    assert set(raw['params']) == {'new_concept_embedding', 'text_encoder',
                                  'unet'}
    assert len(raw['params']['unet']) == 256
    assert len(raw['params']['text_encoder']) == 16
    delta = convert_edlora_delta(raw)
    emb = state.trainable['concept_embedding'].detach().numpy()
    np.testing.assert_array_equal(
        np.asarray(delta['new_concept_embedding']['<c1>']), emb[:16])
    ours = flatten_lora(state.trainable['unet_lora'])
    leaf = delta['unet_lora']['down_blocks']['0']['attentions']['0'][
        'attn1']['to_q']
    np.testing.assert_array_equal(
        np.asarray(leaf['up']),
        ours['down_blocks/0/attentions/0/attn1/to_q']['up'].detach()
        .numpy().T)
    assert np.abs(np.asarray(leaf['up'])).sum() > 0


def test_cli_refuses_what_is_not_ported(tmp_path, monkeypatch):
    """Both CLIs run on the card by default and refuse `--device cuda`
    when no card is visible, rather than running on the CPU; data
    parallelism is ported (test_cli_data_parallel_two_ranks)."""
    yml = _tiny_yml(tmp_path)
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    for cli in (train_edlora, test_edlora):
        with pytest.raises(RuntimeError, match='no CUDA device'):
            cli.main(['-opt', yml, '--device', 'cuda'])
        with pytest.raises(RuntimeError, match='no CUDA device'):
            cli.main(['-opt', yml])


def _sweep_yml(tmp_path, name, lora_path, prompts):
    path = tmp_path / f'{name}.yml'
    path.write_text(yaml.safe_dump({
        'name': name, 'manual_seed': 0, 'mixed_precision': 'no',
        'datasets': {'val_vis': {
            'name': 'PromptDataset', 'prompts': prompts,
            'num_samples_per_prompt': 1, 'latent_size': [4, 8, 8],
            'replace_mapping': {'<TOK>': '<c1> <c2>'},
            'batch_size_per_gpu': 1}},
        'models': {'pretrained_path': 'random:tiny', 'enable_edlora': True,
                   'new_concept_token': '<c1>+<c2>'},
        'path': {'lora_path': str(lora_path),
                 'experiments_root': str(tmp_path / name)},
        'val': {'compose_visualize': True, 'alpha_list': [0.5, 1.0],
                'sample': {'num_inference_steps': 2,
                           'guidance_scale': 7.5}}}))
    return str(path)


def _files(root):
    return {str(p.relative_to(root)): p.read_bytes()
            for p in sorted(root.rglob('*')) if p.suffix in ('.png', '.jpg')}


def test_cli_data_parallel_two_ranks(tmp_path):
    """torchrun's two ranks (gloo, --device cpu) against one process:
    train_edlora at batch 1 a rank (global batch 2) with validation at
    every save gives the delta of one process at batch 2 within 1e-5
    (tests/test_trainer.py's bound), rank 0 alone writing the deltas and
    train states; the validation sweeps and test_edlora (both ranks' share
    of 3 prompts x 2 alphas, on one process's delta) write the file names,
    and for test_edlora the bytes, of one process."""
    import torch_port_ddp as ddp
    prompts = ['a photo of <TOK>', '<TOK> on a beach', '<TOK> in a park']
    (tmp_path / 'prompts.txt').write_text('\n'.join(prompts) + '\n')
    base = yaml.safe_load(open(_tiny_yml(tmp_path)))
    base['datasets']['train']['dataset_enlarge_ratio'] = 2
    base['datasets']['val_vis'] = {
        'name': 'PromptDataset', 'prompts': str(tmp_path / 'prompts.txt'),
        'num_samples_per_prompt': 1, 'latent_size': [4, 8, 8],
        'replace_mapping': {'<TOK>': '<c1> <c2>'}, 'batch_size_per_gpu': 1}
    base['val'] = {'val_during_save': True, 'alpha_list': [1.0],
                   'compose_visualize': True,
                   'sample': {'num_inference_steps': 2,
                              'guidance_scale': 7.5}}
    ymls = {}
    for world in (1, 2):
        opt = copy.deepcopy(base)
        opt['datasets']['train']['batch_size_per_gpu'] = 2 // world
        opt['path'] = {'experiments_root': str(tmp_path / f'train{world}')}
        ymls[world] = tmp_path / f'train{world}.yml'
        ymls[world].write_text(yaml.safe_dump(opt))

    # one torch thread here as in the ranks: the same sums
    _, one, _ = train_edlora.main(['-opt', str(ymls[1]), '--device', 'cpu'])
    delta = tmp_path / 'train1' / 'models' / 'edlora_model-latest.pth'
    ctx = ddp.spawn(2, ddp.cli_rank,
                    ['-opt', str(ymls[2]), '--device', 'cpu'],
                    ['-opt', _sweep_yml(tmp_path, 'sweep2', delta,
                                        str(tmp_path / 'prompts.txt')),
                     '--device', 'cpu'], str(tmp_path), ddp.free_port())
    test_edlora.main(['-opt', _sweep_yml(
        tmp_path, 'sweep1', delta, str(tmp_path / 'prompts.txt')),
        '--device', 'cpu'])
    ddp.join(ctx)

    ranks = [torch.load(tmp_path / f'cli{r}.pt', weights_only=True)
             for r in range(2)]
    assert ddp.max_diff(ranks[0]['final'], ranks[1]['final']) == 0.0
    tags = ('1', '2', 'latest')
    assert sorted(ranks[0]['saved']) == sorted(
        [f'edlora_model-{t}.pth' for t in tags] +
        [f'train_state-{t}.pt' for t in tags])
    assert ranks[1]['saved'] == []          # rank 1 writes none
    assert ddp.max_diff(ranks[0]['final'], ddp.trainable_arrays(one)) <= 1e-5
    for world in (1, 2):
        models = tmp_path / f'train{world}' / 'models'
        assert sorted(os.listdir(models)) == sorted(
            [f'edlora_model-{t}.pth' for t in tags] +
            [f'train_state-{t}.pt' for t in tags])
    ours = convert_edlora_delta(load_edlora_delta(
        str(tmp_path / 'train2' / 'models' / 'edlora_model-latest.pth')))
    np.testing.assert_array_equal(
        np.asarray(ours['new_concept_embedding']['<c1>']),
        ranks[0]['final']['emb'][:16].numpy())
    train_files = [set(_files(tmp_path / f'train{w}' / 'visualization'))
                   for w in (1, 2)]
    assert train_files[0] == train_files[1] and len(train_files[0]) == 12
    sweeps = [_files(tmp_path / f'sweep{w}' / 'visualization')
              for w in (1, 2)]
    assert len(sweeps[0]) == 8 and sweeps[0] == sweeps[1]
