"""The `.safetensors` file format, read and written by hand.

Fused checkpoints are diffusers directories of `.safetensors` files
(mixofshow_tpu/convert/diffusers_export.py). The port writes and reads them
without the `safetensors` package. A file is:
  * 8 bytes: the header's length N, unsigned little-endian;
  * N bytes: a JSON object {name: {"dtype", "shape", "data_offsets": [begin,
    end]}} (plus an optional "__metadata__" of strings), padded with spaces
    to a multiple of 8 bytes;
  * the tensors' raw little-endian bytes, at their offsets from the end of
    the header.
Only F32, F16, BF16 and I64 are taken.
"""
from __future__ import annotations

import json
import struct
from typing import Dict, Optional

import torch

_DTYPES = {'F32': torch.float32, 'F16': torch.float16, 'BF16': torch.bfloat16,
           'I64': torch.int64}
_NAMES = {v: k for k, v in _DTYPES.items()}


def load_file(path: str) -> Dict[str, torch.Tensor]:
    """{name: CPU tensor}; the tensors share one buffer holding the file."""
    with open(path, 'rb') as f:
        data = bytearray(f.read())
    (n,) = struct.unpack('<Q', data[:8])
    header = json.loads(data[8:8 + n].decode('utf-8'))
    start = 8 + n
    out = {}
    for name, info in header.items():
        if name == '__metadata__':
            continue
        if info['dtype'] not in _DTYPES:
            raise TypeError(f'{path}: {name} has dtype {info["dtype"]}; '
                            f'only {sorted(_DTYPES)} are taken')
        dtype = _DTYPES[info['dtype']]
        begin, end = info['data_offsets']
        shape = info['shape']
        count = (end - begin) // dtype.itemsize
        t = torch.frombuffer(data, dtype=dtype, count=count,
                             offset=start + begin) if count else \
            torch.empty(0, dtype=dtype)
        out[name] = t.reshape(shape)
    return out


def save_file(tensors: Dict[str, torch.Tensor], path: str,
              metadata: Optional[Dict[str, str]] = None) -> None:
    """Write {name: tensor} (any device, any strides) in name order."""
    header: Dict = {}
    if metadata:
        header['__metadata__'] = dict(metadata)
    blobs = []
    offset = 0
    for name in sorted(tensors):
        t = tensors[name].detach().to('cpu').contiguous()
        if t.dtype not in _NAMES:
            raise TypeError(f'{name}: dtype {t.dtype} is not one of '
                            f'{sorted(_DTYPES)}')
        raw = t.reshape(-1).view(torch.uint8).numpy()
        header[name] = {'dtype': _NAMES[t.dtype], 'shape': list(t.shape),
                        'data_offsets': [offset, offset + raw.size]}
        blobs.append(raw)
        offset += raw.size
    head = json.dumps(header, separators=(',', ':')).encode('utf-8')
    head += b' ' * (-len(head) % 8)
    with open(path, 'wb') as f:
        f.write(struct.pack('<Q', len(head)))
        f.write(head)
        for raw in blobs:
            f.write(raw.data)
