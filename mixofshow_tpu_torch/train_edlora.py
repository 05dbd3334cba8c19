"""Single-concept ED-LoRA tuning CLI of the port.

    python -m mixofshow_tpu_torch.train_edlora -opt options/train/....yml \
        [--device cuda]

Mirrors the JAX package's root `train_edlora.py` (reference
`train_edlora.py -opt ...`): build the trainer from the YAML `models:`
section, the LoraDataset and its TrainBatcher, total_iter from the dataset
length, log every `logger.print_freq` steps, and save the delta in the
reference `edlora.pth` layout every `logger.save_checkpoint_freq` steps and
at the end (`models/edlora_model-<step|latest>.pth` under the experiment
root). Training runs on one device.

Not in this port yet: `--resume`, `val.val_during_save: true` (validation
sampling during saves) and data parallelism across several devices; asking
for any of them raises.

`main(argv, on_step=None)` runs in-process and returns (trainer, state,
last loss dict); `on_step(global_step, loss_dict)` is called once before
the first step (0, {}) and then after every optimizer update.
"""
from __future__ import annotations

import argparse
import os
from typing import Callable, Optional, Sequence

import torch

from mixofshow_tpu_torch.convert.delta_io import save_edlora_delta
from mixofshow_tpu_torch.data import (DataLoader, LoraDataset, TrainBatcher,
                                      default_collate)
from mixofshow_tpu_torch.pipelines.trainer_edlora import (EDLoRATrainer,
                                                          make_optimizer)
from mixofshow_tpu_torch.utils.logging_utils import (MessageLogger,
                                                     reduce_loss_dict,
                                                     set_path_logger)
from mixofshow_tpu_torch.utils.options import (dict2str, load_options,
                                               resolve_compute_dtype,
                                               set_manual_seed)
from mixofshow_tpu_torch.zoo import load_models


def build_trainer(opt, bundle, device, compute_dtype) -> EDLoRATrainer:
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
        compute_dtype=compute_dtype)


def _refuse_unported(args, opt):
    if args.resume:
        raise NotImplementedError(
            '--resume is not in the port yet (ROADMAP A18)')
    if (opt.get('val') or {}).get('val_during_save'):
        raise NotImplementedError(
            'val.val_during_save: true (validation sampling during saves) '
            'is not in the port yet (ROADMAP A18); set it to false')
    if int(os.environ.get('WORLD_SIZE', '1')) > 1:
        raise NotImplementedError(
            'data-parallel training is not in the port yet (ROADMAP A17); '
            'train on one device')


def save_delta(opt, trainer, state, tag, logger) -> str:
    lora_type = 'edlora' if opt['models'].get('enable_edlora', True) \
        else 'lora'
    path = os.path.join(opt['path']['models'], f'{lora_type}_model-{tag}.pth')
    save_edlora_delta(path, trainer.delta_state_dict(state))
    logger.info(f'Save state to {path}')
    return path


def main(argv: Optional[Sequence[str]] = None,
         on_step: Optional[Callable] = None):
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('-opt', type=str, required=True)
    parser.add_argument('--device', type=str, default='cuda')
    parser.add_argument('--resume', type=str, default=None,
                        help='not in the port yet')
    args = parser.parse_args(argv)
    opt = load_options(args.opt)
    _refuse_unported(args, opt)
    seed = opt.get('manual_seed', 0)
    if opt.get('manual_seed') is not None:
        set_manual_seed(seed)

    logger = set_path_logger(opt, args.opt, is_train=True)
    logger.info(dict2str(opt))
    device = torch.device(args.device)
    compute_dtype = resolve_compute_dtype(opt)
    logger.info(f'device: {device}, compute dtype: {compute_dtype}')
    # fp32 draws (the concept rows start from the fp32 table); the trainer
    # casts the modules to the compute dtype in place
    bundle = load_models(opt['models'].get('pretrained_path'), device,
                         seed=seed)
    trainer = build_trainer(opt, bundle, device, compute_dtype)

    trainset_cfg = opt['datasets']['train']
    train_dataset = LoraDataset(trainset_cfg)
    batcher = TrainBatcher(trainer.tokenizer, trainer.new_concept_cfg,
                           enable_edlora=trainer.enable_edlora)
    batch_size = trainset_cfg['batch_size_per_gpu']
    train_loader = DataLoader(
        train_dataset, batch_size=batch_size, shuffle=True, drop_last=True,
        seed=seed, collate_fn=lambda items: batcher(default_collate(items)))

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
    msg_logger = MessageLogger(opt, 1)
    base_lrs = [opt_cfg.hparams[g][0] for g in ('emb', 'text', 'unet')]
    print_freq = opt.get('logger', {}).get('print_freq', 10)
    save_freq = int(opt.get('logger', {}).get('save_checkpoint_freq', 1e10))
    gen = torch.Generator(device=device).manual_seed(seed)

    global_step, loss_dict = 0, {}
    yielder = train_loader.infinite()
    if on_step is not None:
        on_step(global_step, loss_dict)
    while global_step < total_iter:
        for _ in range(accum):
            loss_dict = trainer.train_step(state, next(yielder), gen)
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
            save_delta(opt, trainer, state, global_step, logger)

    save_delta(opt, trainer, state, 'latest', logger)
    logger.info('training done.')
    return trainer, state, loss_dict


if __name__ == '__main__':
    main()
