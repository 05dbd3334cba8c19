"""ED-LoRA trainer: masked diffusion loss + attention regularization.

Port of mixofshow_tpu/pipelines/trainer_edlora.py (reference
`EDLoRATrainer`, mixofshow/pipelines/trainer_edlora.py:20-379):
  * the trainable state is its own dict {concept_embedding, text_lora,
    unet_lora} of fp32 leaves; the base UNet, CLIP and VAE are frozen
    (`requires_grad_(False)`) and run in the compute dtype (bf16 on the
    card); the loss is computed in fp32;
  * the VAE encode runs under `torch.no_grad()` (the JAX trainer stops the
    gradient at the latents), which is also what lets it run the
    forward-only K2/K3 kernels;
  * the UNet runs with `fuse_attention=False`, so its large
    self-attentions take the differentiable flash attention (K4-K6);
  * three AdamW groups with a linear decay to 0 over `total_steps` counted
    as optax's `linear_schedule` counts it; gradient accumulation averages k
    micro-steps and updates on the k-th, like `optax.MultiSteps`;
  * the sticky embedding freeze: once the mean concept-row norm reaches the
    threshold, the embedding's update is zeroed while Adam's moments still
    advance. The flag stays a device tensor, so a step never syncs.

Random draws (VAE eps, noise, noise offset, timesteps) come from an explicit
`torch.Generator` on the trainer's device, or are handed in as a `draws`
dict (NCHW), so that tests can feed in the JAX trainer's own draws.
Batches use the JAX package's layout: images (B, H, W, 3) in [-1, 1], masks
(B, h, w, 1), text_ids (B, 16, 77), concept_pos (B, 2) and
concept_pos_mask (B, 2), numpy or tensors.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from mixofshow_tpu_torch.diffusion.ddpm import DDPMSchedule, make_ddpm_schedule
from mixofshow_tpu_torch.models import AutoencoderKL, CLIPTextModel, UNet
from mixofshow_tpu_torch.models.lora import (flatten_lora, init_lora_tree,
                                             map_lora, num_lora_leaves)
from mixofshow_tpu_torch.models.vae import sample_latents
from mixofshow_tpu_torch.pipelines.concepts import (NUM_CROSS_ATTENTION_LAYERS,
                                                    all_concept_token_ids,
                                                    init_concepts)
from mixofshow_tpu_torch.text.tokenizer import CLIPTokenizer
from mixofshow_tpu_torch.utils.device import COMPUTE_DTYPE, as_device

GROUPS = ('emb', 'text', 'unet')


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    """What `make_optimizer` settles: (lr, weight decay) per group, betas,
    the schedule length and the accumulation count. `build` makes the torch
    optimizer over a trainable dict."""
    hparams: Dict[str, Tuple[float, float]]
    betas: Tuple[float, float]
    total_steps: int
    grad_accum: int = 1

    def lr_factor(self, update: int) -> float:
        """optax.linear_schedule(lr, 0, total_steps) over the lr, at the
        0-based update count."""
        if self.total_steps <= 0:
            return 1.0
        return 1.0 - min(update, self.total_steps) / self.total_steps

    def build(self, trainable: Dict):
        """(AdamW over the three groups, LambdaLR of `lr_factor`). torch's
        decoupled decay p·(1 − lr·wd) followed by the Adam step is optax's
        adamw update −lr·(m̂/(√v̂ + ε) + wd·p)."""
        params = {'emb': [trainable['concept_embedding']],
                  'text': [t for leaf in flatten_lora(
                      trainable['text_lora']).values() for t in
                      (leaf['down'], leaf['up'])],
                  'unet': [t for leaf in flatten_lora(
                      trainable['unet_lora']).values() for t in
                      (leaf['down'], leaf['up'])]}
        groups = [{'params': params[name], 'lr': self.hparams[name][0],
                   'weight_decay': self.hparams[name][1], 'name': name}
                  for name in GROUPS if params[name]]
        opt = torch.optim.AdamW(groups, betas=self.betas, eps=1e-8)
        sched = torch.optim.lr_scheduler.LambdaLR(opt, self.lr_factor)
        return opt, sched


def make_optimizer(finetune_cfg: Dict, total_steps: int,
                   optim_cfg: Optional[Dict] = None,
                   grad_accum: int = 1) -> OptimizerConfig:
    """Three AdamW groups with the reference's learning rates (text
    embedding 1e-3, text LoRA 1e-5, UNet LoRA 1e-4 unless finetune_cfg
    says otherwise), a shared weight decay (0.01; the embedding may set its
    own) and linear decay to 0 over `total_steps` optimizer updates;
    `grad_accum` > 1 averages that many micro-steps per update."""
    optim_cfg = optim_cfg or {}
    wd = float(optim_cfg.get('weight_decay', 0.01))
    b1, b2 = optim_cfg.get('betas', (0.9, 0.999))
    emb = finetune_cfg.get('text_embedding', {})
    text = finetune_cfg.get('text_encoder', {})
    unet = finetune_cfg.get('unet', {})
    emb_wd = emb.get('weight_decay')
    return OptimizerConfig(
        hparams={'emb': (float(emb.get('lr', 1e-3)),
                         wd if emb_wd is None else float(emb_wd)),
                 'text': (float(text.get('lr', 1e-5)), wd),
                 'unet': (float(unet.get('lr', 1e-4)), wd)},
        betas=(float(b1), float(b2)), total_steps=int(total_steps),
        grad_accum=int(grad_accum))


@dataclasses.dataclass
class TrainState:
    """The trainable leaves, their optimizer and schedule, the micro-step
    count and the sticky freeze flag (a bool tensor on the device)."""
    trainable: Dict
    optimizer: torch.optim.Optimizer
    lr_schedule: torch.optim.lr_scheduler.LambdaLR
    emb_frozen: torch.Tensor
    grad_accum: int = 1
    step: int = 0


def _nearest(x: torch.Tensor, hw) -> torch.Tensor:
    """Nearest resize of (B, C, H, W) with half-pixel centres, as
    jax.image.resize(method='nearest')."""
    if tuple(x.shape[-2:]) == tuple(hw):
        return x
    return F.interpolate(x, size=tuple(hw), mode='nearest-exact')


def attn_reg_loss(cross_probs, masks, concept_pos, concept_pos_mask,
                  attn_reg_weight: float, reg_full_identity: bool,
                  latent_hw: Tuple[int, int]):
    """Cross-attention regularizer (reference trainer_edlora.py:263-313).

    cross_probs: list of (place, layer_idx, probs (B, heads, Q, 77 or 2));
    masks (B, h, w, 1) latent-resolution instance masks; concept_pos (B, 2)
    token positions [adjective, subject], concept_pos_mask marks the ones
    found. Maps are grouped by resolution, averaged over heads and layers,
    each concept map normalized by its global max; the penalty is the
    probability mass outside the mask (adjective always; subject either
    full-mask MSE or outside mass)."""
    h0, w0 = latent_hw
    b = masks.shape[0]
    groups: Dict[int, list] = {}
    for _, _, probs in cross_probs:
        s = int(round((h0 * w0 / probs.shape[2]) ** 0.5))
        groups.setdefault(s, []).append(probs)

    mask_nchw = masks.float().permute(0, 3, 1, 2)
    total = torch.zeros((), dtype=torch.float32, device=masks.device)
    for s, plist in sorted(groups.items()):
        h, w = h0 // s, w0 // s
        cat = torch.cat(plist, dim=1)
        amap = cat.mean(dim=1).reshape(b, h, w, cat.shape[-1]).float()
        if amap.shape[-1] == concept_pos.shape[-1]:
            sel = amap
        else:
            sel = amap.gather(-1, concept_pos[:, None, None, :].expand(
                b, h, w, concept_pos.shape[-1]))
        if concept_pos_mask is not None:
            sel = sel * concept_pos_mask[:, None, None, :]
            v_adj, v_subj = concept_pos_mask[:, 0], concept_pos_mask[:, 1]
        else:
            v_adj = v_subj = torch.ones(b, device=masks.device)
        map_adj, map_subj = sel[..., 0], sel[..., 1]
        map_subj = map_subj / (map_subj.max() + 1e-12)
        map_adj = map_adj / (map_adj.max() + 1e-12)

        gt = _nearest(mask_nchw, (h, w))[:, 0]
        outside = 1.0 - gt
        n_out = outside.sum()
        safe_out = torch.clamp(n_out, min=1.0)
        if reg_full_identity:
            per = ((map_subj - gt) ** 2).mean(dim=(1, 2))
            loss_subj = (per * v_subj).sum() / torch.clamp(v_subj.sum(),
                                                           min=1.0)
        else:
            loss_subj = (map_subj * outside).sum() / safe_out
        loss_adj = (map_adj * outside).sum() / safe_out
        valid = (n_out > 0).float()
        total = total + attn_reg_weight * valid * (loss_subj + loss_adj)
    return total


class EDLoRATrainer:
    """Builds the trainable state and runs the train step on `device`.

    The modules are moved to `device`, cast to `compute_dtype` and frozen IN
    PLACE. The concept table and the LoRA trees are drawn from one numpy
    generator seeded `seed`, in the JAX package's order, so the same seed
    gives the JAX trainer's `trainable_init`."""

    def __init__(self, unet: UNet, text_encoder: CLIPTextModel,
                 vae: AutoencoderKL, tokenizer: Optional[CLIPTokenizer],
                 device, scheduler: Optional[DDPMSchedule] = None,
                 new_concept_token: str = '<new1_1>+<new1_2>',
                 initializer_token: Optional[str] = None,
                 enable_edlora: bool = True,
                 finetune_cfg: Optional[Dict] = None,
                 noise_offset: Optional[float] = None,
                 attn_reg_weight: Optional[float] = None,
                 reg_full_identity: bool = True,
                 use_mask_loss: bool = True,
                 gradient_checkpoint: bool = False,
                 emb_norm_threshold: float = 0.55,
                 seed: int = 0,
                 compute_dtype: torch.dtype = COMPUTE_DTYPE):
        self.device = as_device(device)
        self.tokenizer = tokenizer or CLIPTokenizer()
        self.enable_edlora = enable_edlora
        self.noise_offset = noise_offset
        self.attn_reg_weight = attn_reg_weight
        self.reg_full_identity = reg_full_identity
        self.use_mask_loss = use_mask_loss
        self.gradient_checkpoint = gradient_checkpoint
        self.emb_norm_threshold = emb_norm_threshold
        self.compute_dtype = compute_dtype
        self.finetune_cfg = finetune_cfg or {}
        self.scheduler = (scheduler or make_ddpm_schedule()).to(self.device)

        rng = np.random.default_rng(seed)
        # rows initialised from the base table before it is cast
        self.new_concept_cfg, table = init_concepts(
            self.tokenizer, new_concept_token, initializer_token,
            text_encoder.token_embedding.weight, rng=rng,
            enable_edlora=enable_edlora)
        self.unet, self.text_encoder, self.vae = (
            m.to(device=self.device, dtype=compute_dtype).requires_grad_(
                False).eval() for m in (unet, text_encoder, vae))

        def lora(key, module, path_filter):
            cfg = self.finetune_cfg.get(key, {})
            if not cfg.get('enable_tuning'):
                return {}
            return init_lora_tree(
                rng, module, path_filter,
                rank=int(cfg.get('lora_cfg', {}).get('rank', 4)),
                device=self.device)

        # where=CLIPAttention -> the attention q/k/v/out linears;
        # where=Attention -> attn1 and attn2 to_q/to_k/to_v/to_out
        text_lora = lora('text_encoder', self.text_encoder,
                         lambda p: '/attn/' in p)
        unet_lora = lora('unet', self.unet,
                         lambda p: '/attn1/' in p or '/attn2/' in p)
        self.lora_alpha = float(self.finetune_cfg.get('unet', {})
                                .get('lora_cfg', {}).get('alpha', 1.0))
        self.trainable_init = {
            'concept_embedding': torch.as_tensor(table, device=self.device),
            'text_lora': text_lora, 'unet_lora': unet_lora}
        self.num_text_loras = num_lora_leaves(text_lora)
        self.num_unet_loras = num_lora_leaves(unet_lora)
        self.concept_token_ids = all_concept_token_ids(self.new_concept_cfg)

    # -------------------------------------------------------------- states
    def init_state(self, opt_cfg: OptimizerConfig) -> TrainState:
        """Fresh fp32 copies of `trainable_init` that require grad, and
        their optimizer."""
        trainable = map_lora(self.trainable_init,
                             lambda t: t.detach().clone().float()
                             .requires_grad_(True))
        opt, sched = opt_cfg.build(trainable)
        return TrainState(trainable, opt, sched,
                          torch.zeros((), dtype=torch.bool,
                                      device=self.device),
                          grad_accum=opt_cfg.grad_accum)

    # ---------------------------------------------------------------- loss
    def _tensor(self, x, dtype=None):
        return torch.as_tensor(x).to(self.device, dtype)

    def make_draws(self, b: int, latent_hw: Tuple[int, int],
                   generator: Optional[torch.Generator] = None) -> Dict:
        """One step's random draws, in this order from `generator`: VAE
        eps and noise (B, 4, h, w), noise offset (B, 4, 1, 1), timesteps
        (B,)."""
        kw = dict(generator=generator, device=self.device,
                  dtype=torch.float32)
        shape = (b, self.vae.cfg.latent_channels, *latent_hw)
        return {'vae_eps': torch.randn(shape, **kw),
                'noise': torch.randn(shape, **kw),
                'noise_offset': torch.randn((b, shape[1], 1, 1), **kw),
                'timesteps': torch.randint(
                    0, self.scheduler.num_train_timesteps, (b,),
                    generator=generator, device=self.device)}

    def loss_fn(self, trainable: Dict, batch: Dict,
                generator: Optional[torch.Generator] = None,
                draws: Optional[Dict] = None):
        """(loss, loss_dict): the masked diffusion MSE in fp32 plus the
        attention regularization; loss_dict['loss'] is the MSE alone and
        loss_dict['loss_attn_reg'] the regularizer, as in the JAX trainer.
        Mirrors reference trainer_edlora.py:202-261."""
        cdt = self.compute_dtype
        images = self._tensor(batch['images']).permute(0, 3, 1, 2).to(cdt)
        b, _, hh, ww = images.shape
        f = 2 ** (len(self.vae.cfg.block_out_channels) - 1)
        if draws is None:
            draws = self.make_draws(b, (hh // f, ww // f), generator)
        draws = {k: self._tensor(v) for k, v in draws.items()}

        with torch.no_grad():
            mean, logvar = self.vae.encode(images)
            latents = sample_latents(mean.float(), logvar.float(),
                                     draws['vae_eps'])
            latents = latents * self.vae.cfg.scaling_factor

        noise = draws['noise']
        if self.noise_offset is not None:
            noise = noise + self.noise_offset * draws['noise_offset']
        t = draws['timesteps'].long()
        noisy = self.scheduler.add_noise(latents, noise, t)

        ids = self._tensor(batch['text_ids'], torch.long)
        ehs = self.text_encoder(
            ids.reshape(-1, ids.shape[-1]),
            concept_embedding=trainable['concept_embedding'],
            lora=trainable['text_lora'] or None, lora_alpha=self.lora_alpha)
        if self.enable_edlora:
            ehs = ehs.reshape(b, NUM_CROSS_ATTENTION_LAYERS, *ehs.shape[1:])

        want_probs = self.attn_reg_weight is not None
        pos = self._tensor(batch['concept_pos'], torch.long)
        out = self.unet(noisy.to(cdt), t, ehs,
                        lora=trainable['unet_lora'] or None,
                        lora_alpha=self.lora_alpha,
                        return_cross_probs=want_probs,
                        prob_columns=pos if want_probs else None,
                        remat=self.gradient_checkpoint)
        pred, aux = out if want_probs else (out, None)

        target = self.scheduler.target(latents, noise, t)
        masks = self._tensor(batch['masks'], torch.float32)
        loss_mask = masks if self.use_mask_loss else \
            self._tensor(batch['img_masks'], torch.float32)
        loss_mask = _nearest(loss_mask.permute(0, 3, 1, 2), pred.shape[-2:])
        se = (pred.float() - target.float()) ** 2
        per = (se * loss_mask).sum(dim=(1, 2, 3)) / torch.clamp(
            loss_mask.sum(dim=(1, 2, 3)), min=1.0)
        loss = per.mean()
        loss_dict = {'loss': loss.detach()}
        if want_probs:
            pos_mask = batch.get('concept_pos_mask')
            reg = attn_reg_loss(
                aux['cross_probs'], masks, pos,
                None if pos_mask is None else
                self._tensor(pos_mask, torch.float32),
                self.attn_reg_weight, self.reg_full_identity,
                tuple(pred.shape[-2:]))
            loss = loss + reg
            loss_dict['loss_attn_reg'] = reg.detach()
        return loss, loss_dict

    # ----------------------------------------------------------- train step
    def train_step(self, state: TrainState, batch: Dict,
                   generator: Optional[torch.Generator] = None,
                   draws: Optional[Dict] = None) -> Dict:
        """One micro-step: backward of loss / grad_accum; on every
        grad_accum-th micro-step the optimizer update, the lr schedule
        step and the freeze. Updates `state` in place and returns the loss
        dict (device tensors; reading them syncs)."""
        loss, loss_dict = self.loss_fn(state.trainable, batch, generator,
                                       draws)
        (loss / state.grad_accum).backward()
        state.step += 1
        emb = state.trainable['concept_embedding']
        if state.step % state.grad_accum == 0:
            before = emb.detach().clone()
            state.optimizer.step()
            state.lr_schedule.step()
            state.optimizer.zero_grad(set_to_none=True)
            with torch.no_grad():
                # a frozen embedding keeps its value; Adam's moments moved
                emb.copy_(torch.where(state.emb_frozen, before, emb))
        with torch.no_grad():
            norm_mean = emb.norm(dim=-1).mean()
            state.emb_frozen = state.emb_frozen | (
                norm_mean >= self.emb_norm_threshold)
        loss_dict['Norm_mean'] = norm_mean
        return loss_dict

    # -------------------------------------------------------------- deltas
    def _rows(self, cfg):
        vocab = self.text_encoder.cfg.vocab_size
        return [tid - vocab for tid in cfg['concept_token_ids']]

    def delta_state_dict(self, state: TrainState) -> Dict:
        """Checkpoint payload on the CPU: per-concept embedding rows and the
        two LoRA trees (reference trainer_edlora.py:362-379)."""
        emb = state.trainable['concept_embedding'].detach().cpu()
        return {
            'new_concept_embedding': {
                name: emb[self._rows(cfg)].clone()
                for name, cfg in self.new_concept_cfg.items()},
            'text_lora': map_lora(state.trainable['text_lora'],
                                  lambda t: t.detach().cpu().clone()),
            'unet_lora': map_lora(state.trainable['unet_lora'],
                                  lambda t: t.detach().cpu().clone()),
            'new_concept_cfg': self.new_concept_cfg,
        }

    @torch.no_grad()
    def load_delta_state_dict(self, state: TrainState,
                              delta: Dict) -> TrainState:
        """Copy a `delta_state_dict` payload into the state's leaves in
        place (reference trainer_edlora.py:315-360)."""
        emb = state.trainable['concept_embedding']
        for name, cfg in self.new_concept_cfg.items():
            rows = delta.get('new_concept_embedding', {}).get(name)
            if rows is not None:
                emb[self._rows(cfg)] = self._tensor(rows, emb.dtype)
        for key in ('text_lora', 'unet_lora'):
            new = flatten_lora(delta.get(key) or {})
            for path, leaf in flatten_lora(state.trainable[key]).items():
                for part in ('down', 'up'):
                    leaf[part].copy_(self._tensor(new[path][part]))
        return state
