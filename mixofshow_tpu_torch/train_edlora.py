"""Single-concept ED-LoRA tuning CLI of the port.

    python -m mixofshow_tpu_torch.train_edlora -opt options/train/....yml \
        [--device cuda] [--resume <experiment>/models/train_state-<tag>.pt]
    torchrun --nproc_per_node N -m mixofshow_tpu_torch.train_edlora ...

Mirrors the JAX package's root `train_edlora.py` (reference
`train_edlora.py -opt ...`): build the trainer from the YAML `models:`
section, the LoraDataset and its TrainBatcher, total_iter from the dataset
length, log every `logger.print_freq` steps, and every
`logger.save_checkpoint_freq` steps and at the end save (under the
experiment root's `models/`) the delta in the reference `edlora.pth` layout
(`edlora_model-<step|latest>.pth`), then the whole train state
(`train_state-<step|latest>.pt`, utils/checkpoint.py), then, when
`val.val_during_save` is set, sample the `datasets.val_vis` prompts at each
alpha of `val.alpha_list` into `visualization/Iters-<tag>_Alpha-<alpha>/`.
Validation samples on the trainer's own modules in its compute dtype, with
the live LoRA trees (detached) and the delta's concept table, inside the
pipeline's inference mode; it leaves the modules, their dtypes and flags
as they were and draws nothing from the training generator.

`--resume` loads a train state into the fresh one (a path inside an
experiment root that was archived when this run started is followed into
the archive) and continues from update `step // grad_accum`. As in the JAX
package, the data iterator and the noise generator restart from the seed:
a resumed run sees the batches and draws that the first steps of a fresh
run see, not those the interrupted run would have seen next.

Under torchrun each of the N processes trains on one device (`cuda:
LOCAL_RANK`, NCCL; gloo with `--device cpu`), as the JAX CLI shards over
its mesh: the global batch is `batch_size_per_gpu` x N, `total_iter`, the
log and the schedule count it, every rank loads the whole shuffled global
batch and keeps its rows (parallel.shard_batch), the trainer reduces the
loss and the gradients over the ranks, and rank 0 alone logs and writes the
delta and the train state. Validation sweeps split their batches over the
ranks. `--resume` loads on every rank.

`main(argv, on_step=None, report=None)` runs in-process and returns
(trainer, state, last loss dict). `on_step(global_step, loss_dict)` is
called once before the first step (the starting step, {}) and then after
every optimizer update, before that update's save. `report`, a dict, gets
'resumed' (the loaded state as `train_state_dict` gives it) and 'saves' (a
list of {'tag', 'save_s', 'validation_s'} seconds on the host clock).
"""
from __future__ import annotations

import argparse
import os
import time
from typing import Callable, Dict, Optional, Sequence

import torch

from mixofshow_tpu_torch.convert.delta_io import save_edlora_delta
from mixofshow_tpu_torch.data import (DataLoader, LoraDataset, PromptDataset,
                                      TrainBatcher, default_collate)
from mixofshow_tpu_torch.models.lora import map_lora
from mixofshow_tpu_torch.parallel.mesh import (barrier, close_mesh,
                                               make_mesh, replicate_,
                                               shard_batch)
from mixofshow_tpu_torch.pipelines.pipeline_edlora import EDLoRAPipeline
from mixofshow_tpu_torch.pipelines.trainer_edlora import (EDLoRATrainer,
                                                          make_optimizer)
from mixofshow_tpu_torch.pipelines.validation import visual_validation
from mixofshow_tpu_torch.utils.checkpoint import (load_train_state,
                                                  save_train_state,
                                                  train_state_dict)
from mixofshow_tpu_torch.utils.logging_utils import (MessageLogger,
                                                     reduce_loss_dict,
                                                     set_path_logger)
from mixofshow_tpu_torch.utils.options import (dict2str, load_options,
                                               resolve_compute_dtype,
                                               set_manual_seed)
from mixofshow_tpu_torch.zoo import load_models


def build_trainer(opt, bundle, device, compute_dtype,
                  mesh) -> EDLoRATrainer:
    mcfg = opt['models']
    return EDLoRATrainer(
        bundle.unet, bundle.text_encoder, bundle.vae, bundle.tokenizer,
        device,
        new_concept_token=mcfg['new_concept_token'],
        initializer_token=mcfg.get('initializer_token'),
        enable_edlora=mcfg.get('enable_edlora', True),
        finetune_cfg=mcfg.get('finetune_cfg'),
        noise_offset=mcfg.get('noise_offset'),
        attn_reg_weight=mcfg.get('attn_reg_weight'),
        reg_full_identity=mcfg.get('reg_full_identity', True),
        use_mask_loss=mcfg.get('use_mask_loss', True),
        gradient_checkpoint=mcfg.get('gradient_checkpoint', False),
        emb_norm_threshold=float(opt['train'].get('emb_norm_threshold',
                                                  0.55)),
        seed=opt.get('manual_seed', 0),
        compute_dtype=compute_dtype, mesh=mesh)


def save_and_validation(opt, trainer, state, val_dataset, tag,
                        logger) -> Dict:
    """Save the delta and the train state (rank 0); with
    `val.val_during_save`, sample the validation set at each alpha (the
    ranks' share each). Returns the seconds of each part."""
    t0 = time.perf_counter()
    mesh = trainer.mesh
    lora_type = 'edlora' if opt['models'].get('enable_edlora', True) \
        else 'lora'
    models = opt['path']['models']
    path = os.path.join(models, f'{lora_type}_model-{tag}.pth')
    delta = trainer.delta_state_dict(state)
    if mesh.rank == 0:
        save_edlora_delta(path, delta)
        logger.info(f'Save state to {path}')
        save_train_state(os.path.join(models, f'train_state-{tag}.pt'),
                         state)
    t1 = time.perf_counter()
    if opt['val'].get('val_during_save'):
        table = torch.cat([delta['new_concept_embedding'][name]
                           for name in trainer.new_concept_cfg])
        unet_lora, text_lora = (
            map_lora(state.trainable[k], torch.Tensor.detach) or None
            for k in ('unet_lora', 'text_lora'))
        for alpha in opt['val'].get('alpha_list', [1.0]):
            logger.info(f'validation at alpha={alpha}')
            pipe = EDLoRAPipeline(
                trainer.unet, trainer.text_encoder, trainer.vae,
                trainer.tokenizer, trainer.device, trainer.compute_dtype,
                new_concept_cfg=trainer.new_concept_cfg,
                concept_embedding=table, unet_lora=unet_lora,
                text_lora=text_lora, lora_alpha=float(alpha))
            visual_validation(pipe, val_dataset,
                              f'Iters-{tag}_Alpha-{alpha}', opt, mesh)
    barrier(mesh)
    return {'tag': tag, 'save_s': t1 - t0,
            'validation_s': time.perf_counter() - t1}


def _resume_path(opt, path: str) -> str:
    """Launching with the same experiment root archives the previous one
    (utils/logging_utils.mkdir_and_rename): follow a checkpoint inside it
    into the archive."""
    archived = opt['path'].get('archived_root')
    exp_root = os.path.abspath(opt['path']['experiments_root'])
    if archived and not os.path.exists(path) and \
            os.path.abspath(path).startswith(exp_root):
        return os.path.abspath(path).replace(exp_root, archived, 1)
    return path


def main(argv: Optional[Sequence[str]] = None,
         on_step: Optional[Callable] = None,
         report: Optional[Dict] = None):
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('-opt', type=str, required=True)
    parser.add_argument('--device', type=str, default='cuda')
    parser.add_argument('--resume', type=str, default=None,
                        help='train_state-<tag>.pt file to resume from')
    args = parser.parse_args(argv)
    opt = load_options(args.opt)
    mesh = make_mesh(args.device)
    try:
        return _train(opt, args, mesh, on_step, report)
    finally:
        close_mesh(mesh)


def _train(opt, args, mesh, on_step, report):
    seed = opt.get('manual_seed', 0)
    if opt.get('manual_seed') is not None:
        set_manual_seed(seed)

    logger = set_path_logger(opt, args.opt, is_train=True, mesh=mesh)
    logger.info(dict2str(opt))
    device = mesh.device
    compute_dtype = resolve_compute_dtype(opt)
    logger.info(f'device: {device}, compute dtype: {compute_dtype}, data '
                f'parallel: {mesh.world} process(es), process group '
                f'{mesh.backend}')
    # fp32 draws (the concept rows start from the fp32 table); the trainer
    # casts the modules to the compute dtype in place
    bundle = load_models(opt['models'].get('pretrained_path'), device,
                         seed=seed)
    trainer = build_trainer(opt, bundle, device, compute_dtype, mesh)

    trainset_cfg = opt['datasets']['train']
    train_dataset = LoraDataset(trainset_cfg)
    batcher = TrainBatcher(trainer.tokenizer, trainer.new_concept_cfg,
                           enable_edlora=trainer.enable_edlora)
    # the global batch; every rank loads all of it, because the transforms
    # draw from Python's `random` in load order, and keeps its rows
    batch_size = trainset_cfg['batch_size_per_gpu'] * mesh.world
    train_loader = DataLoader(
        train_dataset, batch_size=batch_size, shuffle=True, drop_last=True,
        seed=seed, collate_fn=lambda items: batcher(default_collate(items)))
    opt['val'] = opt.get('val') or {}
    val_dataset = PromptDataset(opt['datasets']['val_vis']) \
        if opt['val'].get('val_during_save') else None

    accum = opt.get('gradient_accumulation_steps', 1)
    total_iter = int(len(train_dataset) / (batch_size * accum))
    opt['train']['total_iter'] = total_iter
    logger.info('***** Running training *****')
    logger.info(f'  Num examples = {len(train_dataset)}')
    logger.info(f'  Total train batch size = {batch_size * accum}')
    logger.info(f'  Total optimization steps = {total_iter}')
    logger.info(f'  Text-encoder LoRAs = {trainer.num_text_loras}, '
                f'UNet LoRAs = {trainer.num_unet_loras}')

    opt_cfg = make_optimizer(trainer.finetune_cfg, total_iter,
                             opt['train'].get('optim_g'), grad_accum=accum)
    state = trainer.init_state(opt_cfg)
    if args.resume:
        resume_path = _resume_path(opt, args.resume)
        load_train_state(resume_path, state)
        logger.info(f'resumed from {resume_path} at step {state.step}')
        if report is not None:
            report['resumed'] = train_state_dict(state)
    # every rank built the same state from the seed; make it rank 0's
    replicate_((p for group in state.optimizer.param_groups
                for p in group['params']), mesh)
    msg_logger = MessageLogger(opt, 1)
    base_lrs = [opt_cfg.hparams[g][0] for g in ('emb', 'text', 'unet')]
    print_freq = opt.get('logger', {}).get('print_freq', 10)
    save_freq = int(opt.get('logger', {}).get('save_checkpoint_freq', 1e10))
    saves = [] if report is None else report.setdefault('saves', [])
    # a resumed run restarts the noise and the data from the seed, as the
    # JAX package's PRNGKey(seed) and infinite() do
    gen = torch.Generator(device=device).manual_seed(seed)

    # state.step counts micro-steps; the optimizer updates every `accum`
    global_step, loss_dict = state.step // accum, {}
    yielder = train_loader.infinite()
    if on_step is not None:
        on_step(global_step, loss_dict)
    while global_step < total_iter:
        for _ in range(accum):
            loss_dict = trainer.train_step(
                state, shard_batch(mesh, next(yielder)), gen)
        global_step += 1
        if on_step is not None:
            on_step(global_step, loss_dict)
        if global_step % print_freq == 0:
            factor = opt_cfg.lr_factor(global_step)
            log_vars = {'iter': global_step,
                        'lrs': [lr * factor for lr in base_lrs]}
            log_vars.update(reduce_loss_dict(loss_dict))
            msg_logger(log_vars)
        if global_step % save_freq == 0:
            saves.append(save_and_validation(opt, trainer, state,
                                             val_dataset, global_step,
                                             logger))

    saves.append(save_and_validation(opt, trainer, state, val_dataset,
                                     'latest', logger))
    logger.info('training done.')
    return trainer, state, loss_dict


if __name__ == '__main__':
    main()
