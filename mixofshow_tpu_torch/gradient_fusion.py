"""Center-node gradient fusion CLI of the port.

    python -m mixofshow_tpu_torch.gradient_fusion --concept_cfg concepts.json \
        --save_path out/ --pretrained_models <dir | random:sd15> \
        [--device cuda]

Mirrors the JAX package's root `gradient_fusion.py` (the reference's
--concept_cfg/--save_path/--suffix/--pretrained_models/--optimize_*_iters
surface, fuse.sh:1-24) plus `--device`. The iteration counts are used only
by `--solver lbfgs`; the default exact solve needs none. Writes
`<save_path>/combined_model_<suffix>/` and its log beside it.

`main(argv, report=None)` runs in-process and returns (checkpoint dir,
new_concept_cfg); `report` is handed to `compose_concepts`.
"""
from __future__ import annotations

import argparse
import logging
import os
from typing import Dict, Optional, Sequence

from mixofshow_tpu_torch.fusion import compose_concepts
from mixofshow_tpu_torch.utils.logging_utils import LOG_FORMAT, set_logger


def parse_args(argv: Optional[Sequence[str]] = None):
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--concept_cfg', help='json file for multi-concept',
                        required=True, type=str)
    parser.add_argument('--save_path', required=True, type=str,
                        help='folder name to save optimized weights')
    parser.add_argument('--suffix', help='suffix name', default='base',
                        type=str)
    parser.add_argument('--pretrained_models', required=True, type=str)
    parser.add_argument('--optimize_unet_iters', default=50, type=int)
    parser.add_argument('--optimize_textenc_iters', default=500, type=int)
    parser.add_argument('--lam_text', default=1e-4, type=float,
                        help='anchored-ridge strength (text/cross-KV solve)')
    parser.add_argument('--lam_unet', default=1e-4, type=float,
                        help='anchored-ridge strength (spatial solve)')
    parser.add_argument('--spatial_steps', default=20, type=int)
    parser.add_argument('--image_size', default=512, type=int)
    parser.add_argument('--seed', default=0, type=int)
    parser.add_argument('--solver', default='exact', type=str,
                        choices=['exact', 'lbfgs'],
                        help='exact spectral solve (default) or iterative '
                             'LBFGS parity path')
    parser.add_argument('--device', default='cuda', type=str)
    return parser.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None,
         report: Optional[Dict] = None):
    args = parse_args(argv)
    os.makedirs(args.save_path, exist_ok=True)
    logger = set_logger('mixofshow_tpu_torch')
    # this run's log beside its checkpoint, also when an earlier run in the
    # process has set the logger up
    log = logging.FileHandler(os.path.join(
        args.save_path, f'combined_model_{args.suffix}.log'), 'w')
    log.setFormatter(logging.Formatter(LOG_FORMAT))
    logger.addHandler(log)
    try:
        logger.info('%s', args)
        return compose_concepts(
            args.concept_cfg, args.pretrained_models, args.save_path,
            args.device, suffix=args.suffix,
            optimize_textenc_iters=args.optimize_textenc_iters,
            optimize_unet_iters=args.optimize_unet_iters,
            lam_text=args.lam_text, lam_unet=args.lam_unet,
            spatial_steps=args.spatial_steps, image_size=args.image_size,
            seed=args.seed, solver=args.solver, report=report)
    finally:
        logger.removeHandler(log)
        log.close()


if __name__ == '__main__':
    main()
