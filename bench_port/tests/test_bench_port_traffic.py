"""Each sampling cell's traffic, driven through the harness on the CPU at
tiny widths: the program against the plain reference (exactly in float32,
within the cell's limits in bfloat16), each control the cell's file holds
to its limits (the program's int8 serving path, the reference with float8
operands), run through the harness in the program's place, outside them,
and the timed path broken underneath (a solver step that returns its
state, half of a request's rows left out, an image altered where it is
made) read as not correct."""
from __future__ import annotations

import pytest
import torch

from bench_port import check, run
from bench_port import manifest as mf
from bench_port.tests.tiny import TinyManifest

M = mf.Manifest()
CELLS = [w['name'] for w in M.data['workloads']
         if M.traffic(w)['driver'].endswith('_sample')]
CPU = torch.device('cpu')
SEED = 2 ** 31 + 11


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def workload(tmp_path, cell, seed=SEED):
    m = TinyManifest(tmp_path)
    w = m.cell(cell)
    cfg, mix = m.config(w), m.traffic(w)
    return m, cfg, mf.driver(mix['driver']).Workload(cfg, mix, seed, CPU)


@pytest.mark.parametrize('cell', CELLS)
def test_float32_program_is_the_reference(cell, tmp_path):
    """The reference computes what the program computes: in float32 the
    images agree to a level on a handful of pixels."""
    _, cfg, w = workload(tmp_path, cell)
    w.setup(dtype=torch.float32, warm=False)
    run.window(w, count=2)
    check.free_program(w)
    for g in check.image_gaps(w, SEED, CPU, [0, 1]):
        assert g['lat_rel'] < 1e-5
        assert g['img_mad'] < 1e-3 and g['img_max'] <= 1


@pytest.mark.parametrize('cell', CELLS)
def test_a_run_is_correct_and_reports_its_metrics(cell, tmp_path):
    m, _, _ = workload(tmp_path, cell)
    out = run.run_cell(m, cell, SEED, 0.5, 1, CPU)
    assert out['correct'], out['checks']
    assert out['attempted'] >= 1 and out['failed'] == 0
    assert list(out)[-1] == 'checks'
    assert set(out['checks']) == set(m.judgement(m.cell(cell))['limits'])


CONTROLS = [(c, k) for c in CELLS
            for k in M.judgement(M.cell(c))['controls']]


@pytest.mark.parametrize('cell,control', CONTROLS)
def test_each_control_is_not_correct(cell, control, tmp_path):
    m, _, _ = workload(tmp_path, cell)
    out = run.run_cell(m, cell, SEED, 0.2, 0, CPU, control=control)
    assert not out['correct'], out['checks']


def _stuck_step(self, sample, m_prev, model_output, c, i):
    return sample, m_prev


def _half_rows(orig):
    def decode(self, final, output_type):
        half = final[:max(1, final.shape[0] // 2)]
        return orig(self, torch.cat([half] * 2)[:final.shape[0]],
                    output_type)
    return decode


def _altered(orig):
    def decode(self, final, output_type):
        out = orig(self, final, output_type)
        return torch.flip(out, dims=(2,))
    return decode


FAULTS = {
    'state_unchanged': lambda mp: mp.setattr(
        'mixofshow_tpu_torch.diffusion.dpm_solver.DPMSolverMultistep.step',
        _stuck_step),
    'half_of_the_rows': lambda mp: mp.setattr(
        'mixofshow_tpu_torch.pipelines.pipeline_edlora.EDLoRAPipeline.'
        '_decode', _half_rows(_decode())),
    'answer_altered': lambda mp: mp.setattr(
        'mixofshow_tpu_torch.pipelines.pipeline_edlora.EDLoRAPipeline.'
        '_decode', _altered(_decode())),
}


def _decode():
    from mixofshow_tpu_torch.pipelines.pipeline_edlora import EDLoRAPipeline
    return EDLoRAPipeline._decode


def _rows(cell):
    mix = M.traffic(M.cell(cell))
    return mix.get('rows_per_request', mix.get('images_per_request'))


# a request of one image has no half to leave out
CASES = [(c, f) for c in CELLS for f in sorted(FAULTS)
         if f != 'half_of_the_rows' or _rows(c) > 1]


@pytest.mark.parametrize('cell,fault', CASES)
def test_a_broken_timed_path_is_not_correct(cell, fault, tmp_path,
                                            monkeypatch):
    m, _, _ = workload(tmp_path, cell)
    FAULTS[fault](monkeypatch)
    out = run.run_cell(m, cell, SEED, 0.2, 0, CPU)
    assert not out['correct'], out['checks']


@pytest.mark.cuda
def test_cells_are_judged_on_the_card(tmp_path):
    """The same runs on the card at tiny widths."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    m = TinyManifest(tmp_path)
    for cell in CELLS:
        out = run.run_cell(m, cell, SEED, 0.5, 1, torch.device('cuda', 0))
        assert out['correct'], out['checks']
