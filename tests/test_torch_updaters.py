"""Port parity: every updater and schedule of ``deeplearning4j_tpu_torch.nn.
updaters`` against the JAX package's, on the CPU.

Inputs (parameters, gradients, a nonzero updater state) come from numpy
seeds and go into both packages. Tolerances, float32 throughout:
- updates and state after each of three steps: 1e-6 relative per element,
  with an absolute floor of 1e-6 of the tensor's largest entry (where a sum
  such as ``b1 m + (1 - b1) g`` cancels to near zero, a relative bound
  means nothing); the two packages apply the same formulas with float32
  scalars, but some products in another order;
- schedules: 1e-6 relative (the same float32 or float64 expression on both
  sides).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.nn import updaters as JU
from deeplearning4j_tpu_torch.nn import updaters as TU
from torch_port_fixtures import _no_leaked_children_or_shm  # noqa: F401  (per-process leak audit)

RTOL = 1e-6
SCALE_ATOL = 1e-6
SCHEDULE_RTOL = 1e-6

UPDATERS = ["NoOp", "Sgd", "Nesterovs", "AdaGrad", "RmsProp", "AdaDelta", "Adam", "AdaMax",
            "Nadam", "AMSGrad"]
# each schedule with arguments that keep the rate well away from 0 at the
# iterations the tests step through
SCHEDULES = {
    "FixedSchedule": dict(value_=2e-3),
    "ExponentialSchedule": dict(initial_value=1e-2, gamma=0.97),
    "InverseSchedule": dict(initial_value=1e-2, gamma=0.1, power=0.75),
    "StepSchedule": dict(initial_value=1e-2, decay_rate=0.5, step=2.0),
    "PolySchedule": dict(initial_value=1e-2, power=2.0, max_iter=40),
    "SigmoidSchedule": dict(initial_value=1e-2, gamma=0.3, step_size=4),
    "WarmupLinearDecay": dict(peak=1e-2, warmup_steps=4, total_steps=50),
}
# the slots each updater keeps, and whether a slot holds only values >= 0
SLOTS = {"Nesterovs": {"v": False}, "AdaGrad": {"h": True}, "RmsProp": {"g2": True},
         "AdaDelta": {"msg": True, "msdx": True}, "Adam": {"m": False, "v": True},
         "AdaMax": {"m": False, "u": True}, "Nadam": {"m": False, "v": True},
         "AMSGrad": {"m": False, "v": True, "vhat": True}}
SHAPES = {"w": (6, 5), "b": (5,), "k": (2, 3, 4)}


def _pair(name, schedule=None, **kw):
    """(JAX updater, port updater) of one name, with one schedule or none."""
    out = []
    for mod in (JU, TU):
        if schedule is not None:
            kw["lr_schedule"] = getattr(mod, schedule)(**SCHEDULES[schedule])
        out.append(getattr(mod, name)(**kw))
    return out


def _arrays(rs, scale=1.0, nonneg=False):
    return {n: ((rs.rand(*s) if nonneg else rs.randn(*s)) * scale).astype(np.float32)
            for n, s in SHAPES.items()}


def _assert_close(port, ref, what):
    assert set(port) == set(ref), what
    for n, r in ref.items():
        r = np.asarray(r)
        g = port[n].numpy()
        assert g.dtype == np.float32, (what, n, g.dtype)
        atol = SCALE_ATOL * float(np.abs(r).max())
        np.testing.assert_allclose(g, r, rtol=RTOL, atol=atol, err_msg=f"{what} {n}")


@pytest.mark.parametrize("schedule", [None, *SCHEDULES])
@pytest.mark.parametrize("name", UPDATERS)
def test_three_steps_from_a_nonzero_state_match_jax(name, schedule):
    jup, tup = _pair(name, schedule)
    rs = np.random.RandomState(UPDATERS.index(name))
    params = _arrays(rs)
    jstate = {slot: _arrays(rs, 1e-3, nonneg) for slot, nonneg in SLOTS.get(name, {}).items()}
    # both packages start from the same state: the port's tensors are copies
    tstate = {slot: {n: torch.from_numpy(a.copy()) for n, a in d.items()}
              for slot, d in jstate.items()}
    jstate = jax.tree.map(jnp.asarray, jstate)
    assert set(tup.init({n: torch.from_numpy(a) for n, a in params.items()})) == set(jstate)
    tparams = {n: torch.from_numpy(a.copy()) for n, a in params.items()}
    for step, it in enumerate((3, 4, 5)):
        grads = _arrays(rs, 1e-2)
        ref_u, jstate = jup.apply(jax.tree.map(jnp.asarray, grads), jstate,
                                  jax.tree.map(jnp.asarray, params), it, it // 2)
        upd, new = tup.apply({n: torch.from_numpy(g) for n, g in grads.items()}, tstate,
                             tparams, it, it // 2)
        assert new is tstate  # updated in place
        _assert_close(upd, ref_u, f"{name}/{schedule} step {step} updates")
        for slot in jstate:
            _assert_close(tstate[slot], jstate[slot], f"{name}/{schedule} step {step} {slot}")
    if name != "NoOp":
        assert any(np.abs(u.numpy()).max() > 0 for u in upd.values())


# FixedSchedule and WarmupLinearDecay have no schedule_type (in either package)
SCHEDULE_TYPES = [(s, t) for s in SCHEDULES for t in ("ITERATION", "EPOCH")
                  if t == "ITERATION" or "schedule_type" in TU._SCHEDULES[s].__dataclass_fields__]


@pytest.mark.parametrize("schedule,schedule_type", SCHEDULE_TYPES)
def test_schedule_values_match_jax(schedule, schedule_type):
    kw = dict(SCHEDULES[schedule])
    if schedule_type == "EPOCH":
        kw["schedule_type"] = schedule_type
    js, ts = getattr(JU, schedule)(**kw), getattr(TU, schedule)(**kw)
    got, ref = [], []
    for it in range(51):
        for ep in range(6):
            got.append(ts.value(it, ep))
            ref.append(float(js.value(it, ep)))
    assert all(isinstance(x, float) for x in got)
    np.testing.assert_allclose(got, ref, rtol=SCHEDULE_RTOL)
    if schedule_type == "EPOCH":  # the epoch, not the iteration, drives it
        assert ts.value(0, 3) == ts.value(50, 3)


@pytest.mark.parametrize("schedule", [None, *SCHEDULES])
@pytest.mark.parametrize("name", UPDATERS)
def test_json_round_trip_reads_jax_json(name, schedule):
    jup, tup = _pair(name, schedule)
    assert tup.to_json() == jup.to_json()
    assert TU.IUpdater.from_json(jup.to_json()) == tup
    assert TU.IUpdater.from_json(tup.to_json()) == tup


def _accepts(get, name):
    try:
        get(name)
        return True
    except (ValueError, KeyError):
        return False


def test_get_accepts_exactly_the_names_jax_accepts():
    names = []
    for cls in UPDATERS:
        snake = "".join("_" + c.lower() if c.isupper() else c for c in cls).lstrip("_")
        names += [cls, cls.lower(), cls.upper(), snake, snake.upper()]
    names += ["adam_w", "lamb", "sgd_", "", "ams_grad", "a_m_s_grad", "no-op"]
    accepted = [n for n in names if _accepts(JU.get, n)]
    assert [n for n in names if _accepts(TU.get, n)] == accepted
    assert {type(TU.get(n)).__name__ for n in accepted} == set(UPDATERS)
    for n in accepted:
        assert type(TU.get(n)).__name__ == type(JU.get(n)).__name__
    assert TU.get("rms_prop", rms_decay=0.9) == TU.RmsProp(rms_decay=0.9)
    up = TU.Nadam(1e-2)
    assert TU.get(up) is up
    with pytest.raises(ValueError, match="unknown updater"):
        TU.get("adagrad")
    with pytest.raises(ValueError, match="unknown schedule"):
        TU.IUpdater.from_json({"@class": "Sgd", "lr_schedule": {"@class": "Cosine"}})


def test_init_gives_zero_slots_of_each_parameter():
    params = {n: torch.ones(s) for n, s in SHAPES.items()}
    for name in UPDATERS:
        state = getattr(TU, name)().init(params)
        assert set(state) == set(SLOTS.get(name, {}))
        for slot in state.values():
            assert set(slot) == set(SHAPES)
            assert all(t.shape == params[n].shape and not t.any() for n, t in slot.items())
