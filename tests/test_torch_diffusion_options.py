"""The port's diffusion options against the JAX package on the CPU: the
four beta schedules, ``v_posterior`` and the eps / x0 / v parameterizations.

* ``make_schedule``'s float32 tables, and the DDIM tables built from them,
  are bit-equal to JAX's for every schedule x parameterization x
  v_posterior in {0, 0.1}; both packages refuse an unknown schedule or
  parameterization alike;
* the finetune loss and its metrics match JAX ``loss_for_batch`` with the
  x0 and v targets and with the eps target under the sqrt schedule and the
  variational-bound term on (tiny config, seeded weights, the same draws;
  rtol=2e-3, atol=2e-4 as tests/test_torch_training.py); for v the
  trainable gradients match ``jax.grad`` too.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ctrlora_tpu import schedules as jax_sched
from ctrlora_tpu.configs import tiny_test_config as jax_tiny
from ctrlora_tpu.pipeline import CtrLoraPipeline as JaxPipeline
from ctrlora_tpu.training import step as jstep

from ctrlora_tpu_torch import configs, convert, schedules
from ctrlora_tpu_torch.training import step as pstep
from ctrlora_tpu_torch.training import train_state as pts
from tests.test_torch_training import _port_pipeline, loss_draws, seeded_inputs

RTOL, ATOL = 2e-3, 2e-4
SCHEDULES = ("linear", "cosine", "sqrt_linear", "sqrt")
PARAMETERIZATIONS = ("eps", "x0", "v")
TABLES = ("betas", "alphas_cumprod", "sqrt_alphas_cumprod", "sqrt_one_minus_alphas_cumprod",
          "lvlb_weights")
# option sets of the loss checks: (diffusion fields, whether to check gradients)
OPTION_SETS = {
    "v_cosine": (dict(parameterization="v", beta_schedule="cosine"), True),
    "x0_sqrt_linear_elbo": (dict(parameterization="x0", beta_schedule="sqrt_linear",
                                 v_posterior=0.1, original_elbo_weight=1.0), False),
    "eps_sqrt_elbo": (dict(parameterization="eps", beta_schedule="sqrt",
                           original_elbo_weight=1.0), False),
}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One torch thread for these small-model tests (restored after)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(a, b):
    np.testing.assert_allclose(np.asarray(a, np.float32), np.asarray(b, np.float32),
                               rtol=RTOL, atol=ATOL)


def _assert_tables_equal(got, want):
    for name in TABLES:
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name), err_msg=name)
        assert getattr(got, name).dtype == np.float32, name


@pytest.mark.parametrize("v_posterior", [0.0, 0.1])
@pytest.mark.parametrize("parameterization", PARAMETERIZATIONS)
@pytest.mark.parametrize("beta_schedule", SCHEDULES)
def test_schedule_tables_bit_equal_jax(beta_schedule, parameterization, v_posterior):
    kw = dict(beta_schedule=beta_schedule, v_posterior=v_posterior,
              parameterization=parameterization)
    got, want = schedules.make_schedule(**kw), jax_sched.make_schedule(**kw)
    _assert_tables_equal(got, want)
    assert np.isfinite(got.lvlb_weights).all() and np.isfinite(got.alphas_cumprod).all()
    a = schedules.make_ddim_schedule(got, 50, eta=0.5)
    b = jax_sched.make_ddim_schedule(want, 50, eta=0.5)
    for f in dataclasses.fields(b):
        np.testing.assert_array_equal(getattr(a, f.name), getattr(b, f.name), err_msg=f.name)


def test_beta_schedule_shapes_and_clip():
    cosine = schedules.make_beta_schedule("cosine", 1000)
    assert cosine.dtype == np.float64 and cosine.shape == (1000,)
    assert cosine.max() == 0.999 and cosine.min() >= 0
    np.testing.assert_array_equal(cosine, jax_sched.make_beta_schedule("cosine", 1000))
    np.testing.assert_array_equal(schedules.make_beta_schedule("sqrt", 10, 1e-4, 4e-2),
                                  np.linspace(1e-4, 4e-2, 10) ** 0.5)


@pytest.mark.parametrize("make", [schedules.make_schedule, jax_sched.make_schedule],
                         ids=["port", "jax"])
def test_unknown_options_raise(make):
    with pytest.raises(ValueError, match="unknown beta schedule 'quadratic'"):
        make(beta_schedule="quadratic")
    with pytest.raises(NotImplementedError, match="eps2"):
        make(parameterization="eps2")


def _with_options(cfg, options):
    return dataclasses.replace(cfg, diffusion=dataclasses.replace(cfg.diffusion, **options))


@pytest.fixture(scope="module")
def inputs():
    params, batch = seeded_inputs()
    key = jax.random.PRNGKey(5)
    return params, batch, key, loss_draws(key)


@pytest.mark.parametrize("name", list(OPTION_SETS))
def test_loss_matches_jax(inputs, name):
    """The loss and its metrics (and for v the trainable gradients), one JAX
    compile per option set."""
    options, grads = OPTION_SETS[name]
    params, batch, key, draws = inputs
    jpipe = JaxPipeline(_with_options(jax_tiny(n_loras=1), options))
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    loss_fn = lambda p: jstep.loss_for_batch(jpipe, p, jbatch, key)
    if grads:
        (jloss, jmetrics), jgrads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)
    else:
        jloss, jmetrics = jax.jit(loss_fn)(params)

    pipe = _port_pipeline(params, _with_options(configs.tiny_test_config(n_loras=1), options))
    _assert_tables_equal(pipe.schedule, jpipe.schedule)
    tcfg = configs.TrainConfig(trainable="lora")
    mask = pts.trainable_mask(pipe, tcfg)
    pts.make_optimizer(pipe, tcfg, mask)
    loss, metrics = pstep.loss_for_batch(pipe, {k: torch.from_numpy(v) for k, v in batch.items()},
                                         draws=draws)
    _close(loss.item(), jloss)
    for k in ("loss", "loss_simple", "loss_vlb", "t_mean"):
        _close(metrics[k].item(), jmetrics[k])
    if options.get("original_elbo_weight"):  # the bound's term is in the loss
        assert abs(metrics["loss_vlb"].item()) > 1e-3 * abs(metrics["loss_simple"].item())
    if not grads:
        return
    loss.backward()
    ref = convert.params_from_jax(jgrads.control)
    trainable = [n for n, t in mask["control"].items() if t]
    assert trainable
    for n, p in pipe.control.named_parameters():
        if n in trainable:
            _close(p.grad.numpy(), ref[n].numpy())


def test_unknown_target_raises_in_loss(inputs):
    params, batch, _, draws = inputs
    cfg = configs.tiny_test_config(n_loras=1)
    pipe = _port_pipeline(params, cfg)
    pipe.cfg = _with_options(cfg, dict(parameterization="score"))
    with pytest.raises(NotImplementedError, match="score"):
        pstep.loss_for_batch(pipe, {k: torch.from_numpy(v) for k, v in batch.items()},
                             draws=draws)
