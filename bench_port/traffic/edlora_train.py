"""ED-LoRA training as `train_edlora.main` runs a shipped config: the
port's loader thread over a seeded synthetic concept, `EDLoRATrainer.
train_step` once a batch, the loss read on the host every `print_freq`
steps (the CLI's log), no saves or validation.

Mix parameters: `images` (how many 640×512 images the concept has),
`dataset`, `models` and `optim` (the config's datasets.train, models and
train.optim_g entries, with its `replace_mapping`, transforms, batch,
enlarge ratio, learning rates, LoRA rank, noise offset and regularizer),
`print_freq`, `trace_requests` (steps traced). A request is one train
step. Set-up writes the data under TMPDIR, builds the trainer from the
seed's weights and runs the first `check_steps` steps through the
window's own call, keeping what the check compares: each step's loss, the
first gradient as AdamW holds it after step 1, and the leaves after the
last of them.

The controls (`control`, run.py's `--control`), put in the program's
place for the check: 'reference_fp8', the reference's first steps with
float8 operands (e4m3 forward, e5m2 gradients), and 'half_batch', the
reference's first steps on the first half of each batch.
"""
from __future__ import annotations

import math
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from bench_port import build, check, flops
from bench_port.reference import data, sd15, text
from bench_port.reference import train as rtrain

CHECK_STEPS = 3


def flat(trainable):
    """{leaf name: tensor} of the program's trainable dict, in the
    reference's names."""
    out = {'concept_embedding': trainable['concept_embedding']}
    for key, prefix in (('text_lora', 'text'), ('unet_lora', 'unet')):
        def walk(node, path):
            if isinstance(node, dict) and set(node) == {'down', 'up'}:
                out[f'{prefix}/{path}/down'] = node['down']
                out[f'{prefix}/{path}/up'] = node['up']
            elif isinstance(node, dict):
                for k, v in node.items():
                    walk(v, f'{path}/{k}' if path else str(k))
        walk(trainable[key] or {}, '')
    return out


class Workload:
    CONTROLS = ('reference_fp8', 'half_batch')

    def __init__(self, cfg, mix, seed, device, control=None):
        # the training CLI seeds numpy's legacy generator, which takes 32
        # bits; everything here, the reference included, uses this seed
        self.cfg, self.mix, self.device = cfg, mix, device
        self.control = control
        self.seed = seed % 2 ** 32
        self.batch = mix['dataset']['batch_size_per_gpu']
        self.res = next(t['size'] for t in mix['dataset']['instance_transform']
                        if 'size' in t)
        self.waits = {}
        self.first = None
        self.trainer = None

    def train_cfg(self):
        """The reference trainer's settings of this mix."""
        mo, op = self.mix['models'], self.mix['optim']
        ft = mo['finetune_cfg']
        return {'new_concept_token': mo['new_concept_token'],
                'initializer_token': mo['initializer_token'],
                'rank': ft['unet']['lora_cfg']['rank'],
                'alpha': ft['unet']['lora_cfg']['alpha'],
                'lr': {'emb': ft['text_embedding']['lr'],
                       'text': ft['text_encoder']['lr'],
                       'unet': ft['unet']['lr']},
                'weight_decay': op['weight_decay'], 'betas': op['betas'],
                'noise_offset': mo['noise_offset'],
                'attn_reg_weight': mo['attn_reg_weight'],
                'emb_norm_threshold': self.mix['emb_norm_threshold']}

    def length(self):
        return self.mix['images'] * self.mix['dataset'][
            'dataset_enlarge_ratio']

    def total_steps(self):
        return self.length() // self.batch

    # ----------------------------------------------------------- program
    def setup(self, dtype=torch.bfloat16, warm=True):
        from mixofshow_tpu_torch.data import (DataLoader, LoraDataset,
                                              TrainBatcher, default_collate)
        from mixofshow_tpu_torch.parallel.mesh import make_mesh
        from mixofshow_tpu_torch.pipelines.trainer_edlora import (
            EDLoRATrainer, make_optimizer)
        from mixofshow_tpu_torch.text import CLIPTokenizer
        from mixofshow_tpu_torch.utils.options import set_manual_seed

        self.tmp = tempfile.TemporaryDirectory(prefix='bench_port_')
        self.concept = data.write_concept(Path(self.tmp.name), self.seed,
                                          self.mix['images'])
        mo = self.mix['models']
        set_manual_seed(self.seed)
        s = build.program(self.cfg, self.seed, self.device, torch.float32)
        self.mesh = make_mesh(self.device)
        self.trainer = EDLoRATrainer(
            s.unet, s.text_encoder, s.vae, CLIPTokenizer(), self.device,
            new_concept_token=mo['new_concept_token'],
            initializer_token=mo['initializer_token'],
            finetune_cfg=mo['finetune_cfg'],
            noise_offset=mo['noise_offset'],
            attn_reg_weight=mo['attn_reg_weight'],
            reg_full_identity=mo['reg_full_identity'],
            use_mask_loss=mo['use_mask_loss'],
            gradient_checkpoint=mo['gradient_checkpoint'],
            emb_norm_threshold=self.mix['emb_norm_threshold'],
            seed=self.seed, compute_dtype=dtype, mesh=self.mesh)
        del s
        dset = dict(self.mix['dataset'], concept_list=str(self.concept))
        dataset = LoraDataset(dset)
        batcher = TrainBatcher(self.trainer.tokenizer,
                               self.trainer.new_concept_cfg)
        loader = DataLoader(
            dataset, batch_size=self.batch, shuffle=True, drop_last=True,
            seed=self.seed,
            collate_fn=lambda items: batcher(default_collate(items)))
        opt_cfg = make_optimizer(self.trainer.finetune_cfg,
                                 self.total_steps(), self.mix['optim'])
        self.state = self.trainer.init_state(opt_cfg)
        self.gen = torch.Generator(device=self.device).manual_seed(self.seed)
        self.yielder = loader.infinite()
        self.first_steps()

    def first_steps(self):
        """Steps 0 .. CHECK_STEPS - 1 through `start`, keeping the losses,
        the first gradient (AdamW's exp_avg after step 1 over 1 − β1) and
        the leaves before and after."""
        leaves = flat(self.state.trainable)
        before = {k: v.detach().clone() for k, v in leaves.items()}
        beta1 = self.state.optimizer.param_groups[0]['betas'][0]
        losses, grads = [], None
        for i in range(CHECK_STEPS):
            _, loss = self.start(i)
            losses.append(sum(float(v) for k, v in loss.items()
                              if k in ('loss', 'loss_attn_reg')))
            if i == 0:
                moments = self.state.optimizer.state
                grads = {k: moments[v]['exp_avg'].detach().clone()
                         / (1.0 - beta1) if 'exp_avg' in moments[v]
                         else torch.zeros_like(v)
                         for k, v in leaves.items()}
        after = {k: v.detach().clone() for k, v in leaves.items()}
        self.first = {'losses': losses, 'grads': grads,
                      'change': {k: after[k] - before[k] for k in after}}
        self.waits.clear()

    def start(self, i):
        from mixofshow_tpu_torch.parallel.mesh import shard_batch
        t0 = time.perf_counter()
        batch = next(self.yielder)
        self.waits[i] = time.perf_counter() - t0
        return i, self.trainer.train_step(
            self.state, shard_batch(self.mesh, batch), self.gen)

    def finish(self, started):
        i, loss = started
        if (i + 1) % self.mix['print_freq']:
            return self.batch
        return self.batch if all(math.isfinite(float(v))
                                 for v in loss.values()) else 0

    def wait(self):
        if torch.device(self.device).type == 'cuda':
            torch.cuda.synchronize(self.device)

    def close_program(self):
        self.trainer = self.state = self.yielder = None

    def close(self):
        self.tmp.cleanup()

    def reference_gaps(self, seed, device, done, k):
        """The first steps' losses, gradients and change against the
        reference's."""
        sd15.exact_fp32()
        want = self.reference_first(build.reference(self.cfg, self.seed,
                                                    device))
        got = self.first if self.control is None else self.planted(device)
        return [check.train_gaps(got, want)]

    def planted(self, device):
        """The control's first steps, in place of the program's."""
        ref = build.reference(self.cfg, self.seed, device)
        if self.control == 'half_batch':
            return self.reference_first(ref, rows=self.batch // 2)
        for mod in (ref.unet, ref.text_encoder, ref.vae):
            sd15.to_fp8_(mod)
        return self.reference_first(ref)

    # ------------------------------------------------------------- work
    def model_flops(self):
        """Model FLOPs of one step: the UNet forward and its input-gradient
        backward, CLIP's 16 layer-wise prompts a row likewise (the concept
        table trains), the VAE encode."""
        h = w = self.res // 8
        u, c = self.cfg['unet'], self.cfg['text_encoder']
        seqs = self.batch * build.NUM_LAYERS
        return (flops.backward(flops.unet_forward(u, h, w, self.batch),
                               flops.unet_attention(u, h, w, self.batch))
                + flops.backward(flops.clip_text(c, seqs),
                                 flops.clip_attention(c, seqs))
                + flops.vae_encode(self.cfg['vae'], self.res, self.res,
                                   self.batch))

    def flash_work(self):
        h = w = self.res // 8
        return flops.flash_work(self.cfg['unet'], h, w, self.batch, 1024)

    # ------------------------------------------------------- reference
    def reference_batches(self, ref):
        """The first CHECK_STEPS batches, worked out again."""
        mapping = self.mix['dataset']['replace_mapping']
        names, ids = ref.new_concept_cfg, ref.tokenizer
        concept_ids = set(ids.values())
        out = []
        for b in data.batches(self.concept, mapping, self.seed, self.batch,
                              self.length(), CHECK_STEPS, self.res):
            rows = [text.tokenize(text.layer_prompts(p, names), ids)
                    for p in b['prompts']]
            tok = np.stack(rows)
            pos = np.zeros((len(rows), 2), np.int64)
            pos_mask = np.zeros((len(rows), 2), np.float32)
            for r, row in enumerate(tok[:, 0]):
                found = [j for j, t in enumerate(row) if t in concept_ids][:2]
                pos[r, :len(found)] = found
                pos_mask[r, :len(found)] = 1.0
            dev = self.device
            out.append({'images': torch.from_numpy(b['images']).to(dev),
                        'masks': torch.from_numpy(b['masks']).to(dev),
                        'ids': torch.from_numpy(tok).to(dev),
                        'pos': torch.from_numpy(pos).to(dev),
                        'pos_mask': torch.from_numpy(pos_mask).to(dev)})
        return out

    def reference_first(self, ref, rows=None):
        """The reference's losses, first gradients and change over the
        first CHECK_STEPS steps (on each batch's first `rows` rows only:
        the fault of half a batch left out, planted in the reference)."""
        t = self.train_cfg()
        leaves = rtrain.start(self.cfg, t, ref, self.seed, self.device)
        gen = torch.Generator(device=self.device).manual_seed(self.seed)
        tr = rtrain.Trainer(self.cfg, t, ref, leaves, gen,
                            self.total_steps())
        losses, grads = [], None
        with torch.enable_grad():
            for i, batch in enumerate(self.reference_batches(ref)):
                if rows is not None:
                    batch = {k: v[:rows] for k, v in batch.items()}
                loss, g = tr.step(batch)
                losses.append(loss[0])
                if i == 0:
                    grads = g
        change = {k: tr.leaves[k].detach() - leaves[k] for k in leaves}
        return {'losses': losses, 'grads': grads, 'change': change}
