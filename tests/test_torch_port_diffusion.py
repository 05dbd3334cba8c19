"""Port parity for the DPM-Solver++(2M) sampler: coefficient tables and a
whole trajectory against mixofshow_tpu.diffusion at 10 and 50 steps
(atol 1e-5). The tables are fp32 in both packages; XLA's fp32 cumprod and
linspace round in another order than torch's, so they agree to a few ulp,
not bit for bit."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_threads  # noqa: F401  (one torch thread)
from mixofshow_tpu.diffusion import DPMSolverMultistep as JSolver
from mixofshow_tpu.diffusion.ddpm import make_betas as jbetas
from mixofshow_tpu_torch.diffusion import DPMSolverMultistep as PSolver
from mixofshow_tpu_torch.diffusion import make_betas as pbetas

FIELDS = ('timestep', 'alpha_s0', 'sigma_s0', 'alpha_t', 'sigma_t', 'h',
          'r0', 'use_order2')


@pytest.mark.parametrize('schedule', ['scaled_linear', 'linear'])
def test_betas_match_jax(schedule):
    np.testing.assert_allclose(
        pbetas(1000, 0.00085, 0.012, schedule).numpy(),
        np.asarray(jbetas(1000, 0.00085, 0.012, schedule)), atol=1e-8)


@pytest.mark.parametrize('steps', [10, 50])
def test_step_coeffs_match_jax(steps):
    jc, pc = JSolver.create().step_coeffs(steps), \
        PSolver.create().step_coeffs(steps)
    for f in FIELDS:
        a, b = np.asarray(getattr(jc, f)), getattr(pc, f)
        assert a.dtype == b.dtype, f
        np.testing.assert_allclose(b, a, atol=1e-5, rtol=0, err_msg=f)
    np.testing.assert_array_equal(pc.timestep, np.asarray(jc.timestep))
    np.testing.assert_array_equal(pc.use_order2, np.asarray(jc.use_order2))


@pytest.mark.parametrize('steps', [10, 50])
@pytest.mark.parametrize('prediction_type', ['epsilon', 'v_prediction'])
def test_trajectory_matches_jax(steps, prediction_type):
    """Both solvers driven by the same model give the same latents at every
    step. The model is the ideal denoiser of a fixed data sample plus a
    little fixed noise, so the latents stay O(1), as in sampling."""
    js = JSolver.create(prediction_type=prediction_type)
    ps = PSolver.create(prediction_type=prediction_type)
    jc, pc = js.step_coeffs(steps), ps.step_coeffs(steps)
    rng = np.random.default_rng(0)
    x0 = rng.normal(0, 1, (2, 4, 8, 8)).astype(np.float32)
    data = rng.normal(0, 0.5, (2, 4, 8, 8)).astype(np.float32)
    jitter = rng.normal(0, 0.1, (steps, 2, 4, 8, 8)).astype(np.float32)

    def model(x, c, i, asarray):
        a, s = float(c.alpha_s0[i]), float(c.sigma_s0[i])
        d, j = asarray(data), asarray(jitter[i])
        if prediction_type == 'epsilon':
            return (x - a * d) / s + j
        return (a * x - d) / s + j      # v = (a x - x0) / s

    jx, jm = jnp.asarray(x0), jnp.zeros_like(jnp.asarray(x0))
    px, pm = torch.from_numpy(x0), torch.zeros(2, 4, 8, 8)
    for i in range(steps):
        jx, jm = js.step(jx, jm, model(jx, jc, i, jnp.asarray), jc, i)
        px, pm = ps.step(px, pm, model(px, pc, i, torch.from_numpy), pc, i)
        np.testing.assert_allclose(px.numpy(), np.asarray(jx), atol=1e-5,
                                   rtol=0, err_msg=f'step {i}')
    assert px.dtype == torch.float32


def test_lower_order_final_only_below_15_steps():
    s = PSolver.create()
    assert not s.step_coeffs(10).use_order2[-1]
    assert s.step_coeffs(10, lower_order_final=False).use_order2[-1]
    assert s.step_coeffs(50).use_order2[-1]
    assert not s.step_coeffs(50).use_order2[0]
