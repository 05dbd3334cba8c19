"""Ranks of the port's data-parallel tests, spawned on the CPU.

`spawn(world, fn, *args)` starts `world` processes (torch.multiprocessing,
spawn) with torchrun's environment (RANK, WORLD_SIZE, LOCAL_RANK,
MASTER_ADDR, MASTER_PORT on a free localhost port) and one CPU thread
each (tests/torch_port_threads.py, imported with this module), and runs
`fn(rank, *args)` in each; `fn` must be importable (a module-level
function) and writes what it finds under a directory the test reads. `join(ctx)` waits for the ranks and re-raises a rank's error.

This module imports no JAX, so that a rank starts in a few seconds.
"""
from __future__ import annotations

import os
import socket
import time

import numpy as np
import torch
import torch.multiprocessing as mp

import torch_port_threads  # noqa: F401  (one torch thread)


def free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(('127.0.0.1', 0))
        return s.getsockname()[1]


def _entry(rank, world, port, fn, args):
    os.environ.update({'RANK': str(rank), 'WORLD_SIZE': str(world),
                       'LOCAL_RANK': str(rank), 'MASTER_ADDR': '127.0.0.1',
                       'MASTER_PORT': str(port)})
    fn(rank, *args)


def spawn(world: int, fn, *args):
    """Start the ranks without waiting for them."""
    return mp.start_processes(_entry, args=(world, free_port(), fn, args),
                              nprocs=world, join=False,
                              start_method='spawn')


def join(ctx, timeout: float = 600.0) -> None:
    deadline = time.monotonic() + timeout
    while not ctx.join(timeout=1.0):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            raise TimeoutError(f'ranks still running after {timeout} s')


# ------------------------------------------------------------ train steps
FINETUNE = {
    'text_embedding': {'enable_tuning': True, 'lr': 1e-3},
    'text_encoder': {'enable_tuning': True, 'lr': 1e-5,
                     'lora_cfg': {'rank': 4, 'alpha': 1.0}},
    'unet': {'enable_tuning': True, 'lr': 1e-4,
             'lora_cfg': {'rank': 4, 'alpha': 1.0}},
}
TRAINER_KW = dict(new_concept_token='<g1>+<g2>',
                  initializer_token='<rand-0.013>+<rand-0.017>',
                  finetune_cfg=FINETUNE, attn_reg_weight=0.01,
                  reg_full_identity=False, noise_offset=0.01)
PROMPTS = ['a photo of <g1> <g2> at the beach', 'a <g1> <g2> on grass',
           'a photo of <g1> in a garden', '<g1> <g2> next to a cat']


def global_batch(trainer, seed, img=64):
    """A global batch of 4 in the JAX layout: its own mask a sample, the
    third prompt without the subject token."""
    from mixofshow_tpu_torch.pipelines.concepts import bind_concept_prompt
    rng = np.random.default_rng(seed)
    b = len(PROMPTS)
    ids = trainer.tokenizer(bind_concept_prompt(
        PROMPTS, trainer.new_concept_cfg)).reshape(b, 16, 77)
    pos = np.zeros((b, 2), np.int32)
    found = np.zeros((b, 2), np.float32)
    for i in range(b):
        hits = [j for j, t in enumerate(ids[i, 0])
                if t in trainer.concept_token_ids][:2]
        pos[i, :len(hits)] = hits
        found[i, :len(hits)] = 1.0
    lat = img // 8
    masks = np.zeros((b, lat, lat, 1), np.float32)
    for i in range(b):
        masks[i, i:lat - i // 2, 1:lat - 2 * i] = 1.0
    return {'images': rng.normal(size=(b, img, img, 3)).astype(np.float32),
            'text_ids': ids.astype(np.int32), 'masks': masks,
            'img_masks': np.ones((b, img, img, 1), np.float32),
            'concept_pos': pos, 'concept_pos_mask': found}


def build_trainer(modules_path, mesh, **kw):
    """The tiny fp32 trainer on the CPU over the modules saved at
    `modules_path` ({'unet', 'text', 'vae'} state dicts)."""
    from mixofshow_tpu_torch import zoo
    from mixofshow_tpu_torch.models import AutoencoderKL, CLIPTextModel, UNet
    from mixofshow_tpu_torch.pipelines.trainer_edlora import EDLoRATrainer
    from mixofshow_tpu_torch.text import CLIPTokenizer
    sd = torch.load(modules_path, weights_only=True)
    u, c, v = zoo.tiny_configs()
    mods = []
    for cls, cfg, key in ((UNet, u, 'unet'), (CLIPTextModel, c, 'text'),
                          (AutoencoderKL, v, 'vae')):
        m = cls(cfg, 'cpu')
        m.load_state_dict(sd[key])
        mods.append(m)
    return EDLoRATrainer(*mods, CLIPTokenizer(), 'cpu',
                         compute_dtype=torch.float32, mesh=mesh,
                         **dict(TRAINER_KW, **kw))


def trainable_arrays(state):
    from mixofshow_tpu_torch.models.lora import flatten_lora
    out = {'emb': state.trainable['concept_embedding'].detach().clone()}
    for g in ('text_lora', 'unet_lora'):
        for path, leaf in flatten_lora(state.trainable[g]).items():
            for n in ('down', 'up'):
                out[f'{g}/{path}/{n}'] = leaf[n].detach().clone()
    return out


def _grads(state):
    from mixofshow_tpu_torch.models.lora import flatten_lora
    out = {'emb': state.trainable['concept_embedding'].grad.clone()}
    for g in ('text_lora', 'unet_lora'):
        for path, leaf in flatten_lora(state.trainable[g]).items():
            for n in ('down', 'up'):
                out[f'{g}/{path}/{n}'] = leaf[n].grad.clone()
    return out


def run_steps(trainer, batches, accum=1, draws=None, seed=0):
    """`len(batches)` micro-steps on this rank's rows of each global batch
    (parallel.shard_batch); `draws[i]`, when given, are micro-step i's
    global draws, else the trainer draws from a generator seeded `seed`.
    Returns {'losses': per micro-step loss dicts, 'frozen', 'norms',
    'grads': the summed gradients at the first update, 'n_grads': how many
    leaves had a gradient at each update, 'final': the trainables}."""
    from mixofshow_tpu_torch.parallel import shard_batch
    from mixofshow_tpu_torch.pipelines.trainer_edlora import make_optimizer
    mesh = trainer.mesh
    state = trainer.init_state(make_optimizer(FINETUNE, total_steps=10,
                                              grad_accum=accum))
    captured = []
    state.optimizer.register_step_pre_hook(
        lambda *_: captured.append(_grads(state)))
    gen = torch.Generator().manual_seed(seed)
    rec = {'losses': [], 'frozen': [], 'norms': []}
    for i, batch in enumerate(batches):
        mine = shard_batch(mesh, batch)
        d = None if draws is None else shard_batch(mesh, draws[i])
        ld = trainer.train_step(state, mine, gen, draws=d)
        rec['losses'].append({k: float(v) for k, v in ld.items()})
        rec['frozen'].append(bool(state.emb_frozen))
        rec['norms'].append(float(ld['Norm_mean']))
    rec['grads'] = captured[0]
    rec['n_grads'] = [len(c) for c in captured]
    rec['final'] = trainable_arrays(state)
    return rec


def planted_per_rank_normalization(world):
    """The fault a plain DDP wrapper makes: each rank normalizes its
    attention maps by its own maxima and mask counts, and the ranks'
    gradients are averaged (the regularizer's share divided by the world
    size; the MSE already is)."""
    from mixofshow_tpu_torch.pipelines import trainer_edlora as tr
    original = tr.attn_reg_loss

    def local(*args):   # the trainer passes its mesh last
        return original(*args[:-1], None) / world
    tr.attn_reg_loss = local


def train_rank(rank, out_dir, modules_path, scenarios):
    """Run each scenario {'name', 'batches', 'accum', 'draws', 'trainer',
    'fault'} on this rank; save {name: run_steps record} to
    <out_dir>/rank<rank>.pt."""
    from mixofshow_tpu_torch.parallel import close_mesh, make_mesh
    mesh = make_mesh('cpu')
    results = {}
    try:
        for sc in scenarios:
            if sc.get('fault'):
                planted_per_rank_normalization(mesh.world)
            trainer = build_trainer(modules_path, mesh,
                                    **sc.get('trainer', {}))
            results[sc['name']] = run_steps(
                trainer, sc['batches'], sc.get('accum', 1),
                sc.get('draws'))
        results['backend'] = mesh.backend
        results['world'] = mesh.world
    finally:
        close_mesh(mesh)
    torch.save(results, os.path.join(out_dir, f'rank{rank}.pt'))


# ------------------------------------------------------------------- CLIs
def cli_rank(rank, train_argv, test_argv, out_dir, test_port):
    """The train CLI, then the test_edlora CLI, as two torchrun launches
    run them (the second on its own port); saves this rank's final
    trainables and the files its train CLI saved to <out_dir>/cli<rank>.pt."""
    from mixofshow_tpu_torch import test_edlora, train_edlora
    saved = []
    for name in ('save_edlora_delta', 'save_train_state'):
        fn = getattr(train_edlora, name)
        setattr(train_edlora, name, lambda path, *a, fn=fn:
                saved.append(os.path.basename(path)) or fn(path, *a))
    _, state, ld = train_edlora.main(train_argv)
    os.environ['MASTER_PORT'] = str(test_port)
    test_edlora.main(test_argv)
    torch.save({'final': trainable_arrays(state), 'saved': saved,
                'loss': {k: float(v) for k, v in ld.items()}},
               os.path.join(out_dir, f'cli{rank}.pt'))


def max_diff(a, b) -> float:
    assert a.keys() == b.keys()
    return max(float((a[k] - b[k]).abs().max()) for k in a)


__all__ = ['FINETUNE', 'PROMPTS', 'TRAINER_KW', 'build_trainer', 'cli_rank',
           'free_port', 'global_batch', 'join', 'max_diff', 'run_steps',
           'spawn', 'train_rank']
