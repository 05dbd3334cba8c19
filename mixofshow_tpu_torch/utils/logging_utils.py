"""Experiment directories, file+stream logging, iteration message logger.

Port of mixofshow_tpu/utils/logging_utils.py (reference
mixofshow/utils/util.py:25-229): archive-on-collision experiment dirs,
config snapshotting, formatted iteration lines with lr/ETA/losses. Training
loss dicts hold the global batch's values already (the trainer reduces
them over the ranks), so `reduce_loss_dict` only turns them into floats
(the read syncs with the device). Under data parallelism rank 0 alone
makes the directories and logs (`set_path_logger` with a mesh).
"""
from __future__ import annotations

import datetime
import logging
import os
import shutil
import sys
import time
from typing import Dict, Optional

from mixofshow_tpu_torch.parallel.mesh import Mesh, broadcast_object

initialized_loggers = set()
LOG_FORMAT = '%(asctime)s %(levelname)s: %(message)s'


def mkdir_and_rename(path: str):
    """mkdir; if it exists, archive the old one with a timestamp suffix
    (reference util.py:25-35). Returns the archived path or None."""
    archived = None
    if os.path.exists(path):
        archived = path + '_archived_' + time.strftime('%Y%m%d_%H%M%S')
        print(f'Path already exists. Rename it to {archived}', flush=True)
        os.rename(path, archived)
    os.makedirs(path, exist_ok=True)
    return archived


def copy_opt_file(opt_path: str, experiments_root: str):
    """Snapshot the YAML + argv into the experiment dir (util.py:53-67)."""
    os.makedirs(experiments_root, exist_ok=True)
    filename = os.path.join(experiments_root, os.path.basename(opt_path))
    shutil.copyfile(opt_path, filename)
    with open(filename, 'r+') as f:
        lines = f.readlines()
        lines.insert(0, f'# GENERATE TIME: {time.asctime()}\n'
                        f'# CMD: {" ".join(sys.argv)}\n\n')
        f.seek(0)
        f.writelines(lines)


def set_logger(name: str, log_file: Optional[str] = None,
               level=logging.INFO) -> logging.Logger:
    logger = logging.getLogger(name)
    if name in initialized_loggers:
        return logger
    sh = logging.StreamHandler()
    sh.setFormatter(logging.Formatter(LOG_FORMAT))
    logger.addHandler(sh)
    logger.setLevel(level)
    logger.propagate = False
    if log_file is not None:
        fh = logging.FileHandler(log_file, 'w')
        fh.setFormatter(logging.Formatter(LOG_FORMAT))
        logger.addHandler(fh)
    initialized_loggers.add(name)
    return logger


def set_path_logger(opt: Dict, opt_path: str, is_train: bool = True,
                    logger_name: str = 'mixofshow_tpu_torch',
                    mesh: Optional[Mesh] = None) -> logging.Logger:
    """Create the experiment dir layout + root logger (util.py:70-101):
    `path.experiments_root` when the options set it, else
    experiments/<name> (results/<name> when not training). With a mesh,
    rank 0 does that and the other ranks take its `opt['path']` and a
    logger that prints warnings only."""
    if mesh is not None and mesh.rank != 0:
        opt['path'] = broadcast_object(None, mesh)
        return set_logger(logger_name, level=logging.WARNING)
    logger = _set_path_logger(opt, opt_path, is_train, logger_name)
    if mesh is not None:
        broadcast_object(opt['path'], mesh)
    return logger


def _set_path_logger(opt, opt_path, is_train, logger_name):
    opt['path'] = dict(opt.get('path') or {})
    exp_root = opt['path'].get('experiments_root') or os.path.join(
        'experiments' if is_train else 'results', opt['name'])
    opt['path']['experiments_root'] = exp_root
    opt['path']['models'] = os.path.join(exp_root, 'models')
    opt['path']['log'] = exp_root
    opt['path']['visualization'] = os.path.join(exp_root, 'visualization')
    opt['path']['archived_root'] = mkdir_and_rename(exp_root)
    os.makedirs(opt['path']['models'], exist_ok=True)
    os.makedirs(opt['path']['visualization'], exist_ok=True)
    copy_opt_file(opt_path, exp_root)
    log_file = os.path.join(exp_root,
                            f"train_{opt['name']}_{int(time.time())}.log")
    return set_logger(logger_name, log_file)


class MessageLogger:
    """Formatted iteration lines: epoch-free iter/lr/ETA/losses
    (reference util.py:143-200)."""

    def __init__(self, opt: Dict, start_iter: int = 1,
                 logger_name: str = 'mixofshow_tpu_torch'):
        self.exp_name = opt.get('name', 'exp')
        self.interval = opt.get('logger', {}).get('print_freq', 10)
        self.start_iter = start_iter
        self.max_iters = opt.get('train', {}).get('total_iter', 0)
        self.start_time = time.time()
        self.logger = logging.getLogger(logger_name)

    def __call__(self, log_vars: Dict):
        current_iter = log_vars.pop('iter')
        lrs = log_vars.pop('lrs', [])

        msg = (f'[{self.exp_name[:31]}..][Iter:{current_iter:8,d}, '
               f'lr:(' + ', '.join(f'{v:.3e}' for v in lrs) + ')] ')
        if self.max_iters:
            total_time = time.time() - self.start_time
            done = max(current_iter - self.start_iter, 1)
            eta = total_time / done * (self.max_iters - current_iter)
            msg +=f'[eta: {datetime.timedelta(seconds=int(eta))}] '
        for k, v in log_vars.items():
            msg += f'{k}: {float(v):.4e} '
        self.logger.info(msg)


def reduce_loss_dict(loss_dict: Dict) -> Dict:
    """The loss dict as floats (reference util.py:203-229 averages across
    processes; the port's trainer returns the global batch's values)."""
    return {k: float(v) for k, v in loss_dict.items()}
