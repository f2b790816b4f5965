"""The sharded MST++ train step (``models/train.py:make_sharded_train_step``)
on a world of 4 CPU ranks, against the port's single-process step and the
JAX ``make_sharded_train_step``.

One spawned world runs three meshes, dp 2 x sp 2, dp 2 x tp 2 and
sp 2 x tp 2, three steps each, on one batch of 4 x 32x32 (the published
MST++ at one stage, as ``tests/test_torch_train.py`` trains it), from the
same seeded weights as the single-process step; then dp 2 x sp 2 from the
JAX ``init_state``'s weights, against the JAX sharded step on the same
mesh over 4 of the 8 virtual devices. Bars (those of
``tests/test_torch_train.py``): losses within 1e-5 relative (against
JAX, after the first step 1e-4, that file's bar once Adam has moved the
parameters: elements whose gradient is at noise level may step the other
way), parameters after step 1 and step 3 within the Adam bound (max 2 x
the sum of the rates, RMS 1e-4 of it), every rank's parameters equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_parallel_checks as checks

from animal_vision_tpu.models import train as jtrain
from animal_vision_tpu.models.mst_plus_plus import MSTPlusPlus as JMSTPlusPlus
from animal_vision_tpu.parallel import make_mesh as jmake_mesh
from animal_vision_tpu_torch.models import train
from animal_vision_tpu_torch.models.mst_plus_plus import MSTPlusPlus, from_jax_params
from animal_vision_tpu_torch.parallel.launch import spawn

CONFIGS = [(2, 2, 1), (2, 1, 2), (1, 2, 2)]
JAX_CONFIG = (2, 2, 1)
STEPS, STAGE, BATCH, PATCH = 3, 1, 4, 32
LOSS_REL = 1e-5
TRAIL_REL = 1e-4  # later steps against JAX: tests/test_torch_train.py's bar after Adam updates
RMS_OF_BOUND = 1e-4
TIMEOUT_S = 300


@pytest.fixture(autouse=True, scope="module")
def few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def batch():
    rng = np.random.default_rng(11)
    rgb = rng.uniform(0, 1, (BATCH, PATCH, PATCH, 3)).astype(np.float32)
    hsi = rng.uniform(0.05, 1, (BATCH, PATCH, PATCH, 31)).astype(np.float32)
    return rgb, hsi


def _cfg():
    return train.make_optimizer(lr=checks.LR, total_steps=checks.TOTAL, warmup=checks.WARMUP)


def _bound(count: int) -> float:
    return 2 * sum(_cfg().schedule(c) for c in range(count))


def _params_agree(got: dict, want: dict, bound: float) -> None:
    assert sorted(got) == sorted(want)
    diffs = np.concatenate([(got[k] - want[k]).ravel() for k in want])
    assert np.abs(diffs).max() <= bound, (float(np.abs(diffs).max()), bound)
    assert np.sqrt(np.mean(diffs ** 2)) <= RMS_OF_BOUND * bound


@pytest.fixture(scope="module")
def single(batch):
    """The single-process step from the same seeded weights."""
    state = train.init_state(MSTPlusPlus(stage=STAGE), _cfg(), seed=0, device="cpu")
    step = train.make_train_step("mrae")
    metrics, params = [], {}
    for i in range(STEPS):
        state, m = step(state, *batch)
        metrics.append({k: float(v) for k, v in m.items()})
        if i in (0, STEPS - 1):
            params[i + 1] = {k: v.detach().numpy().copy() for k, v in state.model.named_parameters()}
    return metrics, params


@pytest.fixture(scope="module")
def jax_side():
    """The JAX module, optimizer and initial state (stage 1, seed 0)."""
    module = JMSTPlusPlus(stage=STAGE)
    opt = jtrain.make_optimizer(lr=checks.LR, total_steps=checks.TOTAL, warmup=checks.WARMUP)
    return module, opt, jtrain.init_state(module, opt, sample_shape=(1, PATCH, PATCH, 3), seed=0)


@pytest.fixture(scope="module")
def world(batch, jax_side):
    """One world: the three meshes from the seeded weights, then dp 2 x sp 2
    from the JAX initial weights."""
    init = {k: v.numpy() for k, v in from_jax_params(jax_side[2].params["params"]).items()}
    runs = [(dims, dims, None) for dims in CONFIGS] + [("jax", JAX_CONFIG, init)]
    res = spawn(checks.train_checks, 4, "cpu", timeout=TIMEOUT_S, runs=runs, rgb=batch[0], hsi=batch[1],
                steps=STEPS, stage=STAGE)
    return [{r["name"]: r for r in rank} for rank in res]


@pytest.mark.parametrize("dims", CONFIGS)
def test_sharded_step_matches_single_process(world, single, dims):
    want_m, want_p = single
    got = world[0][dims]
    assert got["step"] == STEPS
    for a, b in zip(got["metrics"], want_m):
        assert abs(a["loss"] - b["loss"]) <= LOSS_REL * abs(b["loss"]), (got["metrics"], want_m)
        assert abs(a["rmse"] - b["rmse"]) <= LOSS_REL * abs(b["rmse"])
        assert abs(a["psnr"] - b["psnr"]) <= 1e-4
    for count in (1, STEPS):
        _params_agree(got["params"][count], want_p[count], _bound(count))
    assert all(r[dims]["same"] for r in world)  # every rank holds the same parameters


def test_sharded_step_matches_jax_sharded_step(world, batch, jax_side):
    """dp 2 x sp 2 from the JAX init, against the JAX sharded step over 4
    of the 8 virtual devices."""
    dp, sp, tp = JAX_CONFIG
    module, opt, state = jax_side
    mesh = jmake_mesh(jax.devices()[:dp * sp * tp], dp=dp, sp=sp, tp=tp)
    step, place = jtrain.make_sharded_train_step(mesh, module, opt)
    state = place(state)
    got = world[0]["jax"]
    for i in range(STEPS):
        with mesh:
            state, m = step(state, jnp.asarray(batch[0]), jnp.asarray(batch[1]))
        bar = LOSS_REL if i == 0 else TRAIL_REL
        assert abs(got["metrics"][i]["loss"] - float(m["loss"])) <= bar * abs(float(m["loss"])), i
        if i + 1 in got["params"]:
            want = {k: v.numpy() for k, v in from_jax_params(jax.device_get(state.params)["params"]).items()}
            _params_agree(got["params"][i + 1], want, _bound(i + 1))
    assert all(r["jax"]["same"] for r in world)
