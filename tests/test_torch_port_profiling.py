"""utils/profiling.py on the CPU: StepTimer's summary is the JAX
package's on the same step times, and trace writes a Chrome trace of the
block's operators."""
import json

import pytest
import torch

import torch_port_threads  # noqa: F401  (one torch thread)
from mixofshow_tpu.utils.profiling import StepTimer as JStepTimer
from mixofshow_tpu_torch.utils.profiling import StepTimer, trace


@pytest.mark.parametrize('times,skip', [([0.5, 0.2, 0.3], 1), ([0.4], 1),
                                        ([], 1), ([0.1, 0.2, 0.6], 0)])
def test_step_timer_summary_matches_jax(times, skip):
    ours, theirs = StepTimer('cpu'), JStepTimer(sync=False)
    ours.times, theirs.times = list(times), list(times)
    assert ours.summary(skip) == theirs.summary(skip)


def test_step_timer_times_each_step():
    timer = StepTimer('cpu')
    for _ in range(3):
        with timer:
            torch.ones(64, 64) @ torch.ones(64, 64)
    s = timer.summary()
    assert s['steps'] == 3 and 0 < s['min_s'] <= s['mean_s'] <= s['max_s']
    with pytest.raises(ValueError, match='explicit device'):
        StepTimer(None)


def test_trace_writes_a_chrome_trace(tmp_path):
    with trace(str(tmp_path / 'tr'), 'cpu') as prof:
        torch.ones(32, 32) @ torch.ones(32, 32)
    names = {e.key for e in prof.key_averages()}
    assert 'aten::matmul' in names or 'aten::mm' in names
    events = json.loads((tmp_path / 'tr' / 'trace.json').read_text())
    assert any('mm' in e.get('name', '') for e in events['traceEvents'])
