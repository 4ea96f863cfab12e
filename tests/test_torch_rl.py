"""The port's ``rl`` package (``deeplearning4j_tpu_torch.rl``) against the JAX
package's ``rl``: environments, replay and frame processing draw for draw
from the same seeds; the learners from carried weights (``port_net`` for the
Q-networks, ``actor_critic_params_from_jax`` for the actor-critic tree).

Tolerances: host numpy (environments, replay samples, frames, returns) is
compared exactly; a Q-update's loss within 1e-5 (relative) of JAX's; the
networks after a run within 1e-4 of each tensor's norm (the
MultiLayerNetwork update limit of ``torch_mln_helpers``; float32 products
in another order, through a few dozen Adam or RMSProp steps); episode
rewards, which follow from the actions, equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.rl import actor_critic as JAC
from deeplearning4j_tpu.rl import envs as JE
from deeplearning4j_tpu.rl import history as JH
from deeplearning4j_tpu.rl import mdp as JM
from deeplearning4j_tpu.rl import qlearning as JQ
from deeplearning4j_tpu_torch.models.weights import actor_critic_params_from_jax
from deeplearning4j_tpu_torch.rl import actor_critic as TAC
from deeplearning4j_tpu_torch.rl import envs as TE
from deeplearning4j_tpu_torch.rl import history as TH
from deeplearning4j_tpu_torch.rl import mdp as TM
from deeplearning4j_tpu_torch.rl import qlearning as TQ
from torch_mln_helpers import GRAD_REL, LOSS_REL, port_net
from torch_port_fixtures import _no_leaked_children_or_shm  # noqa: F401  (per-process leak audit)


def _net_close(tnet, jnet, rel=GRAD_REL):
    want = jax.tree.map(np.asarray, jnet.params_)
    for si, pd in tnet.params_.items():
        for k, p in pd.items():
            err = np.linalg.norm(p.detach().numpy() - want[si][k]) / np.linalg.norm(want[si][k])
            assert err <= rel, (si, k, err)


def _tree_close(tparams, jparams, rel=GRAD_REL):
    for k, layer in jparams.items():
        for n, w in layer.items():
            w = np.asarray(w)
            err = np.linalg.norm(tparams[k][n].numpy() - w) / max(np.linalg.norm(w), 1e-30)
            assert err <= rel, (k, n, err)


# ----------------------------------------------------- host-side pieces


def test_cartpole_trajectories_equal_jax():
    for seed in (0, 3):
        tenv, jenv = TE.CartPoleEnv(seed, max_steps=60), JE.CartPoleEnv(seed, max_steps=60)
        np.testing.assert_array_equal(tenv.reset()[0], jenv.reset()[0])
        acts = np.random.RandomState(seed).randint(0, 2, 80)
        for a in acts:
            t, j = tenv.step(int(a)), jenv.step(int(a))
            np.testing.assert_array_equal(t[0], j[0])
            assert t[1:] == j[1:]
            if t[2] or t[3]:
                np.testing.assert_array_equal(tenv.reset(seed=seed + 1)[0],
                                              jenv.reset(seed=seed + 1)[0])


def test_exp_replay_samples_equal_jax():
    trep, jrep = TQ.ExpReplay(50, 8, seed=4), JQ.ExpReplay(50, 8, seed=4)
    rs = np.random.RandomState(1)
    for i in range(70):  # past max_size: the ring drops the oldest
        s, s2 = rs.randn(4).astype(np.float32), rs.randn(4).astype(np.float32)
        for rep in (trep, jrep):
            rep.store(s, i % 2, float(i), s2, float(i % 7 == 0))
        if i >= 10 and i % 9 == 0:
            for got, want in zip(trep.sample(), jrep.sample()):
                assert got.dtype == want.dtype
                np.testing.assert_array_equal(got, want)
    assert len(trep) == len(jrep) == 50


def test_toy_mdp_and_spaces_equal_jax():
    tm, jm = TM.SimpleToyMDP(5, 12), JM.SimpleToyMDP(5, 12)
    np.testing.assert_array_equal(tm.reset(), jm.reset())
    rs = np.random.RandomState(2)
    while not jm.is_done():
        a = int(rs.randint(0, 2))
        t, j = tm.step(a), jm.step(a)
        np.testing.assert_array_equal(t[0], j[0])
        assert t[1:] == j[1:] and tm.is_done() == jm.is_done()
    r1, r2 = np.random.RandomState(9), np.random.RandomState(9)
    assert [TM.DiscreteSpace(7).random_action(r1) for _ in range(20)] == \
        [JM.DiscreteSpace(7).random_action(r2) for _ in range(20)]
    assert tm.getObservationSpace.shape == jm.getObservationSpace.shape == (5,)


class _FakeGym:
    """A gym-shaped stand-in: 5-tuple steps (or the legacy 4-tuple), reset
    returning (obs, info) or the bare observation, spaces as attributes."""

    class _Space:
        def __init__(self, n=None, shape=None):
            self.n, self.shape = n, shape

    def __init__(self, legacy=False):
        self.legacy = legacy
        self.action_space = self._Space(n=3)
        self.observation_space = self._Space(shape=(2,))
        self.t = 0
        self.closed = False

    def reset(self):
        self.t = 0
        obs = np.zeros(2)
        return obs if self.legacy else (obs, {"start": True})

    def step(self, a):
        self.t += 1
        obs = np.array([self.t, a], np.float64)
        if self.legacy:
            return obs, 0.5, self.t >= 3, {"t": self.t}
        return obs, 0.5, False, self.t >= 3, {"t": self.t}

    def close(self):
        self.closed = True


@pytest.mark.parametrize("legacy", [False, True])
def test_gym_adapter_over_a_fake_env_equals_jax(legacy):
    tenv, jenv = _FakeGym(legacy), _FakeGym(legacy)
    tm, jm = TE.GymEnvAdapter(tenv), JE.GymEnvAdapter(jenv)
    assert tm.action_space.size == jm.action_space.size == 3
    assert tm.observation_space.shape == jm.observation_space.shape == (2,)
    t0, j0 = tm.reset(), jm.reset()
    assert t0.dtype == j0.dtype == np.float32
    for a in (2, 0, 1):
        t, j = tm.step(a), jm.step(a)
        np.testing.assert_array_equal(t[0], j[0])
        assert t[1:] == j[1:] and t[0].dtype == np.float32
    assert tm.is_done() and jm.is_done()
    tm.close()
    assert tenv.closed
    bare = type("Bare", (), {"reset": lambda s: np.zeros(1), "step": lambda s, a: None})()
    for A in (TE.GymEnvAdapter, JE.GymEnvAdapter):
        with pytest.raises(ValueError, match="n_actions"):
            A(bare)
        with pytest.raises(ValueError, match="obs_shape"):
            A(bare, n_actions=2)


def _frames(rs, n, shape, dtype):
    if dtype == np.uint8:
        return [rs.randint(0, 256, shape).astype(np.uint8) for _ in range(n)]
    return [rs.rand(*shape).astype(np.float32) for _ in range(n)]


@pytest.mark.parametrize("shape,dtype", [((20, 24, 3), np.uint8), ((16, 16), np.float32)])
def test_history_processor_equals_jax(shape, dtype):
    kw = dict(history_length=3, rescaled_width=12, rescaled_height=10, cropping_width=8,
              cropping_height=6, offset_x=2, offset_y=1, skip_frame=2)
    tp = TH.HistoryProcessor(TH.HistoryProcessorConfiguration(**kw))
    jp = JH.HistoryProcessor(JH.HistoryProcessorConfiguration(**kw))
    np.testing.assert_array_equal(tp.history(), jp.history())  # empty: zeros
    frames = _frames(np.random.RandomState(3), 9, shape, dtype)
    tp.start(frames[0])
    jp.start(frames[0])
    for f in frames[1:]:
        assert tp.record(f) == jp.record(f)
        got, want = tp.getHistory(), jp.getHistory()
        assert got.shape == (3, 6, 8) and got.dtype == np.float32
        np.testing.assert_array_equal(got, want)


# ------------------------------------------------------------ DQN


SMALL_Q = dict(seed=7, max_epoch_step=40, max_step=110, exp_rep_max_size=500, batch_size=16,
               target_dqn_update_freq=25, update_start=30, eps_anneal_steps=60)


def _qlearners(double_dqn=True):
    cfg = dict(SMALL_Q, double_dqn=double_dqn)
    jl = JQ.QLearningDiscrete(JE.GymEnvAdapter(JE.CartPoleEnv(5)),
                              JQ.QLearningConfiguration(**cfg), hidden=16)
    tnet = port_net(jl.qnet)
    tl = TQ.QLearningDiscrete(TE.GymEnvAdapter(TE.CartPoleEnv(5)),
                              TQ.QLearningConfiguration(**cfg), q_network=tnet)
    return jl, tl


@pytest.mark.parametrize("double_dqn", [True, False])
def test_dqn_updates_equal_jax(double_dqn):
    """The same replay samples (same RandomState) through JAX's jitted step
    and the port's: each update's loss, then the network after them."""
    jl, tl = _qlearners(double_dqn)
    rs = np.random.RandomState(0)
    env = JE.CartPoleEnv(1)
    obs = env.reset()[0]
    for _ in range(60):
        a = int(rs.randint(0, 2))
        nxt, r, term, trunc, _ = env.step(a)
        for rep in (jl.replay, tl.replay):
            rep.store(obs, a, r, nxt, float(term))
        obs = env.reset()[0] if term or trunc else nxt
    step = jl._train_step()
    for _ in range(6):
        s, a, r, s2, d = jl.replay.sample()
        jl.qnet.params_, jl.qnet.updater_state, jloss = step(
            jl.qnet.params_, jl.target_params, jl.qnet.updater_state,
            jnp.asarray(jl.qnet.iteration, jnp.int32), jnp.asarray(s), jnp.asarray(a),
            jnp.asarray(r), jnp.asarray(s2), jnp.asarray(d))
        jl.qnet.iteration += 1
        tloss = tl._learn()
        assert abs(float(tloss) - float(jloss)) <= LOSS_REL * abs(float(jloss))
    assert tl.qnet.iteration == jl.qnet.iteration == 6
    _net_close(tl.qnet, jl.qnet)


def test_dqn_training_run_equals_jax():
    jl, tl = _qlearners()
    jr, tr = jl.train(), tl.train()
    assert tr == jr and len(tr) > 1  # identical actions give identical episodes
    assert tl.step_count == jl.step_count == SMALL_Q["max_step"]
    assert tl.epsilon() == jl.epsilon()
    _net_close(tl.qnet, jl.qnet)
    obs = np.random.RandomState(2).randn(4).astype(np.float32)
    assert tl.get_policy().next_action(obs) == jl.get_policy().next_action(obs)
    assert tl.getPolicy().play(TE.GymEnvAdapter(TE.CartPoleEnv(9)), 50) == \
        jl.getPolicy().play(JE.GymEnvAdapter(JE.CartPoleEnv(9)), 50)


def test_async_nstep_q_with_one_thread_equals_jax():
    kw = dict(SMALL_Q, max_step=90, n_step=5, num_threads=1, target_dqn_update_freq=20)
    factory = {"jax": lambda i: JE.GymEnvAdapter(JE.CartPoleEnv(11 + i)),
               "torch": lambda i: TE.GymEnvAdapter(TE.CartPoleEnv(11 + i))}
    jl = JH.AsyncNStepQLearningDiscrete(factory["jax"], JH.AsyncQLearningConfiguration(**kw),
                                        hidden=16)
    tl = TH.AsyncNStepQLearningDiscrete(factory["torch"], TH.AsyncQLearningConfiguration(**kw),
                                        hidden=16, device="cpu")
    tl.qnet = port_net(jl.qnet)
    tl.target_params = TQ.clone_params(tl.qnet)
    jr, tr = jl.train(), tl.train()
    assert tr == jr and tl.global_steps == jl.global_steps
    assert tl.qnet.iteration == jl.qnet.iteration > 10
    _net_close(tl.qnet, jl.qnet)


def test_async_worker_errors_reach_the_caller():
    def broken(i):
        env = TE.GymEnvAdapter(TE.CartPoleEnv(i))
        if i == 1:
            env.step = lambda a: (_ for _ in ()).throw(RuntimeError("env died"))
        return env

    cfg = TH.AsyncQLearningConfiguration(max_step=40, num_threads=2, eps_anneal_steps=1)
    with pytest.raises(RuntimeError, match="env died"):
        TH.AsyncNStepQLearningDiscrete(broken, cfg, hidden=8, device="cpu").train()


# ------------------------------------------------------ actor-critic


def test_actor_critic_loss_gradients_and_returns_equal_jax():
    jp = jax.tree.map(np.asarray, JAC.init_actor_critic(jax.random.key(3), 4, 3, (8, 6)))
    tp = actor_critic_params_from_jax(jp, device="cpu")
    rs = np.random.RandomState(4)
    obs = rs.randn(10, 4).astype(np.float32)
    acts = rs.randint(0, 3, 10)
    rets = rs.randn(10).astype(np.float32)
    for got, want in zip(TAC.actor_critic_forward(tp, torch.from_numpy(obs)),
                         JAC.actor_critic_forward(jp, jnp.asarray(obs))):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)
    cfg = dict(learning_rate=0.01, vf_coef=0.5, ent_coef=0.01)
    jnew, jopt, jl = JAC._make_update(JAC.A3CConfiguration(**cfg))(
        jp, jax.tree.map(np.zeros_like, jp), jnp.asarray(obs), jnp.asarray(acts, jnp.int32),
        jnp.asarray(rets))
    tnew, topt, tl = TAC._make_update(TAC.A3CConfiguration(**cfg))(
        tp, TAC._zeros_like(tp), torch.from_numpy(obs), torch.from_numpy(acts).long(),
        torch.from_numpy(rets))
    assert abs(float(tl) - float(jl)) <= LOSS_REL * abs(float(jl))
    _tree_close(tnew, jnew)
    _tree_close(topt, jopt)
    r, d = rs.randn(7).astype(np.float32), (rs.rand(7) < 0.3).astype(np.float32)
    np.testing.assert_array_equal(TAC._nstep_returns(r, 0.7, d, 0.95),
                                  JAC._nstep_returns(r, 0.7, d, 0.95))
    p = TAC.init_actor_critic(0, 4, 3, device="cpu")
    assert {k: tuple(v["W"].shape) for k, v in p.items()} == {
        "h0": (4, 64), "h1": (64, 64), "pi": (64, 3), "v": (64, 1)}


def test_a2c_vectorized_updates_equal_jax():
    kw = dict(seed=2, t_max=5, learning_rate=1e-3)
    jcfg, tcfg = JAC.A3CConfiguration(**kw), TAC.A3CConfiguration(**kw)
    mk = {"jax": [0], "torch": [0]}

    def factory(pkg, E):
        def make():
            mk[pkg][0] += 1
            return E.GymEnvAdapter(E.CartPoleEnv(30 + mk[pkg][0]))
        return make

    ja = JAC.A2CVectorized(factory("jax", JE), jcfg, 4, 2, n_envs=4)
    ta = TAC.A2CVectorized(factory("torch", TE), tcfg, 4, 2, n_envs=4, device="cpu")
    ta.params = actor_critic_params_from_jax(jax.tree.map(np.asarray, ja.params), device="cpu")
    ja.train(updates=6)
    ta.train(updates=6)
    assert ta.episode_rewards == ja.episode_rewards
    _tree_close(ta.params, ja.params)
    _tree_close(ta.opt, ja.opt)
    obs = np.zeros(4, np.float32)
    assert ta.policy().next_action(obs) == ja.policy().next_action(obs)


def test_a3c_with_one_thread_equals_jax():
    kw = dict(seed=1, t_max=6, num_threads=1, learning_rate=1e-3)
    ja = JAC.A3CDiscrete(lambda: JE.GymEnvAdapter(JE.CartPoleEnv(40)),
                         JAC.A3CConfiguration(**kw), 4, 2)
    ta = TAC.A3CDiscrete(lambda: TE.GymEnvAdapter(TE.CartPoleEnv(40)),
                         TAC.A3CConfiguration(**kw), 4, 2, device="cpu")
    ta.params = actor_critic_params_from_jax(jax.tree.map(np.asarray, ja.params), device="cpu")
    ja.train(total_steps=60)
    ta.train(total_steps=60)
    assert ta.episode_rewards == ja.episode_rewards
    _tree_close(ta.params, ja.params)
    env = TE.GymEnvAdapter(TE.CartPoleEnv(41))
    assert ta.policy().play(env, 30) == ja.policy().play(JE.GymEnvAdapter(JE.CartPoleEnv(41)),
                                                         30)
    with pytest.raises(RuntimeError, match="cuda"):
        TAC.A2CVectorized(lambda: env, TAC.A3CConfiguration(), 4, 2)
