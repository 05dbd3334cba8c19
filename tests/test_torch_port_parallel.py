"""Data parallelism of the port (parallel/mesh.py) on the CPU.

Two gloo ranks at 2 rows each against one process at the whole batch of
4, and against the JAX package's single-device step. One spawn of two
ranks (tests/torch_port_ddp.py) runs every scenario while this process
computes the one-process runs and the JAX gradient.

The batch makes the ranks differ where the loss couples rows: each sample
has its own instance mask (so the ranks' mask counts differ), the
attention maps' maxima differ by rank, and one sample's subject token is
missing (concept_pos_mask 0, so the found-subject counts differ).

Bounds: the trainables after the updates within 1e-5 absolute of one
process's (tests/test_trainer.py's data-parallel bound); the summed
gradients of the first update within atol 1e-5 + rtol 1e-3 of each
group's largest entry of JAX's (the bound test_torch_port_train.py holds
a JAX step's gradients to: fp32 sums in another order).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_ddp as ddp
import torch_port_threads  # noqa: F401  (one torch thread)
from mixofshow_tpu.models import init_clip_text, init_unet, init_vae
from mixofshow_tpu.parallel import make_mesh as jmake_mesh
from mixofshow_tpu.parallel import shard_batch as jshard_batch
from mixofshow_tpu.pipelines import trainer_edlora as jtr
from mixofshow_tpu.text import CLIPTokenizer as JTokenizer
from mixofshow_tpu_torch import zoo
from mixofshow_tpu_torch.convert import load_jax_params, lora_from_jax
from mixofshow_tpu_torch.models import AutoencoderKL, CLIPTextModel, UNet
from mixofshow_tpu_torch.models.lora import flatten_lora
from mixofshow_tpu_torch.parallel import Mesh, shard_batch
from test_torch_port_train import _jax_draws

U, C, V = zoo.tiny_configs()
ATOL = 1e-5
# between the embedding's mean row norm after the 1st (0.11506) and the
# 2nd (0.11536) update of the 'plain' run: the sticky freeze sets after
# the 2nd and holds the embedding at the 3rd
THRESHOLD = 0.1152


def _jax_grads(params, batch, key):
    jt = jtr.EDLoRATrainer(params['unet'], params['text'], params['vae'],
                           tokenizer=JTokenizer(), unet_config=U,
                           text_config=C, vae_config=V,
                           compute_dtype=jnp.float32, **ddp.TRAINER_KW)
    (_, _), grads = jax.jit(
        lambda tr, k, bt, fr: jax.value_and_grad(jt.loss_fn, has_aux=True)(
            tr, k, bt, fr))(jt.trainable_init, key,
                            {k: jnp.asarray(v) for k, v in batch.items()},
                            jt.frozen_params)
    out = {'emb': torch.from_numpy(np.asarray(grads['concept_embedding']))}
    for g in ('text_lora', 'unet_lora'):
        tree = lora_from_jax(jax.tree.map(np.asarray, grads[g]), 'cpu')
        for path, leaf in flatten_lora(tree).items():
            for n in ('down', 'up'):
                out[f'{g}/{path}/{n}'] = leaf[n]
    return out


@pytest.fixture(scope='module')
def runs(tmp_path_factory):
    """{'ranks': [rank 0's, rank 1's records], 'one': one process's records,
    'jax': JAX's gradients of the 'plain' run's first update}."""
    root = tmp_path_factory.mktemp('ddp')
    params = {'unet': init_unet(0, U), 'text': init_clip_text(1, C),
              'vae': init_vae(2, V)}
    mods = root / 'modules.pt'
    torch.save({'unet': load_jax_params(UNet(U, 'cpu'),
                                        params['unet']).state_dict(),
                'text': load_jax_params(CLIPTextModel(C, 'cpu'),
                                        params['text']).state_dict(),
                'vae': load_jax_params(AutoencoderKL(V, 'cpu'),
                                       params['vae']).state_dict()}, mods)
    probe = ddp.build_trainer(str(mods), None)
    batches = [ddp.global_batch(probe, s) for s in range(4)]
    draws = [_jax_draws(jax.random.PRNGKey(i), 4, 8) for i in range(3)]
    scenarios = [
        {'name': 'plain', 'batches': batches[:3], 'draws': draws,
         'trainer': {'emb_norm_threshold': THRESHOLD}},
        {'name': 'accum', 'batches': batches, 'accum': 2,
         'trainer': {'reg_full_identity': True}},
        {'name': 'fault', 'batches': batches[:3], 'draws': draws,
         'trainer': {'emb_norm_threshold': THRESHOLD}, 'fault': True}]
    ctx = ddp.spawn(2, ddp.train_rank, str(root), str(mods), scenarios)
    one = {sc['name']: ddp.run_steps(
        ddp.build_trainer(str(mods), None, **sc['trainer']),
        sc['batches'], sc.get('accum', 1), sc.get('draws'))
        for sc in scenarios[:2]}
    jgrads = _jax_grads(params, batches[0], jax.random.PRNGKey(0))
    ddp.join(ctx)
    ranks = [torch.load(root / f'rank{r}.pt', weights_only=False)
             for r in range(2)]
    return {'ranks': ranks, 'one': one, 'jax': jgrads, 'batch': batches[0]}


@pytest.mark.parametrize('name', ['plain', 'accum'])
def test_two_ranks_give_one_process_update(runs, name):
    """'plain': 3 updates fed JAX's draws; 'accum': gradient accumulation
    over 2 micro-steps, reg_full_identity, the draws from the seeded
    generator (every rank draws the global batch's and keeps its rows)."""
    r0, r1 = (r[name] for r in runs['ranks'])
    one = runs['one'][name]
    assert runs['ranks'][0]['backend'] == 'gloo'
    assert runs['ranks'][0]['world'] == 2
    assert ddp.max_diff(r0['final'], r1['final']) == 0.0   # replicated
    assert ddp.max_diff(r0['final'], one['final']) <= ATOL
    for a, b, c in zip(r0['losses'], r1['losses'], one['losses']):
        assert a == b       # the logged loss is the global batch's
        for k in c:
            np.testing.assert_allclose(a[k], c[k], rtol=1e-5, atol=1e-7)


def test_planted_per_rank_normalization_is_over_the_bound(runs):
    """Per-rank maxima and mask counts with averaged gradients (a plain
    DDP wrapper around the one-process loss) land over the bound the
    right reduction meets."""
    fault = runs['ranks'][0]['fault']['final']
    assert ddp.max_diff(fault, runs['one']['plain']['final']) > 10 * ATOL


def test_emb_frozen_agrees_across_ranks(runs):
    """The sticky freeze is computed from the updated, replicated embedding:
    both ranks set it at the same step as one process does."""
    r0, r1 = (r['plain'] for r in runs['ranks'])
    one = runs['one']['plain']
    assert r0['norms'] == r1['norms']
    assert r0['frozen'] == r1['frozen'] == one['frozen'] == \
        [False, True, True]


def test_two_ranks_match_the_jax_step(runs):
    """The gradients summed over the two ranks at the first update equal
    the JAX trainer's at the whole batch of 4 with the same draws."""
    got, want = runs['ranks'][0]['plain']['grads'], runs['jax']
    assert got.keys() == want.keys()
    assert float(want['emb'].abs().max()) > 0
    for group in ('emb', 'text_lora', 'unet_lora'):
        keys = [k for k in want if k.split('/')[0] == group]
        scale = max(float(want[k].abs().max()) for k in keys)
        for k in keys:
            np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                       rtol=0, atol=ATOL + 1e-3 * scale,
                                       err_msg=k)


def test_shard_batch_matches_jax_shards(runs):
    """Rank r's rows are JAX device r's shard of the same global batch
    (`shard_batch(make_mesh(2), batch)` on the virtual CPU devices)."""
    batch = runs['batch']
    jmesh = jmake_mesh(2)
    sharded = jshard_batch(jmesh, batch)
    devices = list(jmesh.devices.reshape(-1))
    for r in range(2):
        mine = shard_batch(Mesh(r, 2, torch.device('cpu')), batch)
        for key, arr in sharded.items():
            shard = [s.data for s in arr.addressable_shards
                     if s.device == devices[r]]
            assert len(shard) == 1
            np.testing.assert_array_equal(np.asarray(shard[0]), mine[key])


def test_shard_batch_refuses_a_ragged_batch():
    with pytest.raises(ValueError, match='multiple of the world size'):
        shard_batch(Mesh(0, 2, torch.device('cpu')),
                    {'x': np.zeros((3, 1))})
    batch = {'x': np.arange(4)}
    assert shard_batch(Mesh(0, 1, torch.device('cpu')), batch) is batch


def test_make_mesh_without_torchrun_is_one_process(monkeypatch):
    from mixofshow_tpu_torch.parallel import make_mesh
    monkeypatch.delenv('WORLD_SIZE', raising=False)
    mesh = make_mesh('cpu')
    assert (mesh.rank, mesh.world, mesh.group, mesh.backend) == \
        (0, 1, None, None)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match='no CUDA device'):
            make_mesh('cuda')

