"""Host-side batching: dataset → fixed-shape numpy batches.

Port of mixofshow_tpu/data/loader.py, jax-free: the same shuffles from the
same numpy seed, so both packages see identical batches. Two pieces:

  * DataLoader: shuffled, drop-last, background-thread prefetched batch
    iterator over any indexable dataset. The datasets are tiny (5-20 images
    repeated ×500, lora_dataset.py:74 in the reference), so a
    double-buffered thread pipeline hides host work behind device steps.
  * TrainBatcher: moves all string work (concept prompt binding,
    tokenization, concept-token position lookup) out of the train step;
    batches reach the trainer as int32/float32 arrays only.
"""
from __future__ import annotations

import queue
import threading
from typing import Callable, Dict, Iterator, List, Optional

import numpy as np

from mixofshow_tpu_torch.pipelines.concepts import (
    NUM_CROSS_ATTENTION_LAYERS, all_concept_token_ids, bind_concept_prompt)
from mixofshow_tpu_torch.utils.profiling import span


class DataLoader:
    """Minimal epoch-shuffled batch loader with background prefetch."""

    def __init__(self, dataset, batch_size: int, shuffle: bool = True,
                 drop_last: bool = True, seed: int = 0,
                 collate_fn: Optional[Callable[[List[Dict]], Dict]] = None,
                 prefetch: int = 2):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.rng = np.random.default_rng(seed)
        self.collate_fn = collate_fn or default_collate
        self.prefetch = prefetch

    def __len__(self) -> int:
        n = len(self.dataset)
        return n // self.batch_size if self.drop_last else \
            -(-n // self.batch_size)

    def _index_batches(self) -> Iterator[np.ndarray]:
        order = np.arange(len(self.dataset))
        if self.shuffle:
            self.rng.shuffle(order)
        end = (len(order) // self.batch_size * self.batch_size
               if self.drop_last else len(order))
        for i in range(0, end, self.batch_size):
            yield order[i:i + self.batch_size]

    def __iter__(self) -> Iterator[Dict]:
        q: 'queue.Queue' = queue.Queue(maxsize=self.prefetch)
        sentinel = object()

        def worker():
            try:
                for idxs in self._index_batches():
                    items = [self.dataset[int(i)] for i in idxs]
                    q.put(self.collate_fn(items))
                q.put(sentinel)
            except BaseException as exc:  # surface in the consumer thread
                q.put(exc)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        while True:
            with span('data.wait'):
                item = q.get()
            if item is sentinel:
                break
            if isinstance(item, BaseException):
                raise item
            yield item

    def infinite(self) -> Iterator[Dict]:
        """Endless re-iteration (reference train_edlora.py:92-98)."""
        while True:
            yield from self


def default_collate(items: List[Dict]) -> Dict:
    out: Dict = {}
    for key in items[0]:
        vals = [it[key] for it in items]
        if isinstance(vals[0], np.ndarray):
            out[key] = np.stack(vals)
        elif isinstance(vals[0], (int, float, np.integer, np.floating)):
            out[key] = np.asarray(vals)
        else:
            out[key] = vals  # strings etc.
    return out


class TrainBatcher:
    """Tensorize a LoraDataset batch for the train step.

    Adds to each collated batch:
      text_ids (B, 16, 77) — bind_concept_prompt + tokenize;
      concept_pos (B, 2) + concept_pos_mask — positions of concept tokens in
      the layer-0 ids (reference trainer_edlora.py:275-279), padded/clamped
      to exactly 2 (adjective, subject) as cal_attn_reg expects.
    """

    def __init__(self, tokenizer, new_concept_cfg: Dict,
                 enable_edlora: bool = True, max_concept_tokens: int = 2):
        self.tokenizer = tokenizer
        self.new_concept_cfg = new_concept_cfg
        self.enable_edlora = enable_edlora
        self.max_concept_tokens = max_concept_tokens
        self.concept_ids = set(all_concept_token_ids(new_concept_cfg))

    def __call__(self, batch: Dict) -> Dict:
        prompts: List[str] = batch.pop('prompts')
        b = len(prompts)
        if self.enable_edlora:
            bound = bind_concept_prompt(prompts, self.new_concept_cfg)
            ids = self.tokenizer(bound).reshape(
                b, NUM_CROSS_ATTENTION_LAYERS, -1)
        else:
            ids = self.tokenizer(prompts).reshape(b, 1, -1)

        k = self.max_concept_tokens
        pos = np.zeros((b, k), np.int32)
        pos_mask = np.zeros((b, k), np.float32)
        for i in range(b):
            found = [j for j, t in enumerate(ids[i, 0])
                     if int(t) in self.concept_ids][:k]
            pos[i, :len(found)] = found
            pos_mask[i, :len(found)] = 1.0

        out = dict(batch)
        out['text_ids'] = ids.astype(np.int32)
        out['concept_pos'] = pos
        out['concept_pos_mask'] = pos_mask
        if 'masks' not in out:  # no instance masks -> loss over placement mask
            out['masks'] = out['img_masks']
        return out
