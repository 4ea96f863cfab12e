"""Helpers the MultiLayerNetwork and ComputationGraph parity tests share
(``tests/test_torch_nn_*``, ``test_torch_multilayer.py``,
``test_torch_text_lstm.py``, ``test_torch_graph*.py`` and the graph models').

Inputs and weights are numpy arrays from a seed and go into both packages;
JAX runs on the CPU, as the JAX package's own tests run it. A layer is held
to its JAX twin by its output and by the vector-Jacobian product of one
seeded cotangent: the gradient with respect to the input and to every
parameter.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from deeplearning4j_tpu.nn import conf as JC
from deeplearning4j_tpu_torch.nn import conf as TC

OUT_ATOL = 1e-5      # layer outputs, absolute
GRAD_REL = 1e-4      # each gradient's (or update's) error, of its norm
LOSS_REL = 1e-5      # losses and scores, relative


def pair(cls_name, **kw):
    """(JAX layer, port layer) of one class with the same fields."""
    jl = getattr(JC, cls_name, None)
    if jl is None:
        from deeplearning4j_tpu.nn import attention_layers as JA
        from deeplearning4j_tpu_torch.nn import attention_layers as TA

        return getattr(JA, cls_name)(**kw), getattr(TA, cls_name)(**kw)
    return jl(**kw), getattr(TC, cls_name)(**kw)


def random_params(jlayer, it, rs, scale=0.5):
    """The JAX layer's parameter shapes, filled from ``rs``."""
    shapes = jax.tree.map(lambda a: a.shape, jlayer.init_params(jax.random.key(0), it))
    return {k: (rs.randn(*s) * scale).astype(np.float32) for k, s in shapes.items()}


def t(a, grad=False):
    return torch.tensor(np.asarray(a), requires_grad=grad)


def close(got, want, atol=OUT_ATOL, what=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=atol, err_msg=what)


def rel_err(got, want):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want, np.float64)
    n = np.linalg.norm(want)
    return np.linalg.norm(got - want) / (n if n > 0 else 1.0)


def grads_close(got: dict, want: dict, rel=GRAD_REL):
    assert set(got) == set(want), (sorted(got), sorted(want))
    for k in want:
        e = rel_err(got[k], want[k])
        assert e <= rel, f"gradient {k}: error {e:.2e} of its norm"


def vjp_pair(jfn, tfn, params, x, cot):
    """Outputs and gradients (input and every parameter) of ``jfn(p, x)``
    and ``tfn(p, x)`` under the cotangent ``cot``; returns
    (jax out, jax grads, port out, port grads), grads keyed by parameter
    name plus ``"x"``."""
    jout, vjp = jax.vjp(jfn, jax.tree.map(jnp.asarray, params), jnp.asarray(x))
    jgp, jgx = vjp(jnp.asarray(cot))
    jgrads = {**jax.tree.map(np.asarray, jgp), "x": np.asarray(jgx)}
    tp = {k: t(v, True) for k, v in params.items()}
    tx = t(x, True)
    tout = tfn(tp, tx)
    names = list(tp)
    gs = torch.autograd.grad(tout, [tp[n] for n in names] + [tx], grad_outputs=t(cot),
                             allow_unused=True)
    tgrads = {n: (torch.zeros_like(tp[n]) if g is None else g) for n, g in zip(names, gs[:-1])}
    tgrads["x"] = gs[-1]
    return np.asarray(jout), jgrads, tout, tgrads


def port_net(jnet, tconf=None):
    """A CPU port network of ``tconf`` (default: the JAX network's
    configuration, through its JSON) with the JAX network's parameters, BN
    state and updater state."""
    from deeplearning4j_tpu_torch.models.weights import mln_params_from_jax
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork

    if tconf is None:
        tconf = TC.MultiLayerConfiguration.from_json(jnet.conf.to_json())
    net = MultiLayerNetwork(tconf, device="cpu").init()
    to_np = lambda tree: jax.tree.map(np.asarray, tree)  # noqa: E731
    return mln_params_from_jax(net, to_np(jnet.params_), to_np(jnet.bn_state),
                               to_np(jnet.updater_state))


def port_graph(jnet, tconf=None):
    """A CPU port ComputationGraph of ``tconf`` (default: the JAX graph's
    configuration, through its JSON) with the JAX graph's parameters, BN
    state and updater state."""
    from deeplearning4j_tpu_torch.models.weights import cg_params_from_jax
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
    from deeplearning4j_tpu_torch.nn.graph_conf import ComputationGraphConfiguration

    if tconf is None:
        tconf = ComputationGraphConfiguration.from_json(jnet.conf.to_json())
    net = ComputationGraph(tconf, device="cpu").init()
    to_np = lambda tree: jax.tree.map(np.asarray, tree)  # noqa: E731
    return cg_params_from_jax(net, to_np(jnet.params_), to_np(jnet.bn_state),
                              to_np(jnet.updater_state))


def params_close(tnet, jnet, before=None, rel=GRAD_REL):
    """Every parameter of the two networks (MultiLayerNetworks or
    ComputationGraphs) equal, as an update: within ``rel`` of the norm of
    (JAX parameter - ``before``), or of the parameter's norm when ``before``
    is None."""
    jp = jax.tree.map(np.asarray, jnet.params_)
    assert sum(len(v) for v in jp.values()) == len(list(tnet._param_entries()))
    for si, k, p in tnet._param_entries():
        want = jp[si][k].astype(np.float64)
        got = p.detach().numpy().astype(np.float64)
        if before is not None:
            want, got = want - before[si][k], got - before[si][k]
        n = np.linalg.norm(want)
        e = np.linalg.norm(got - want) / (n if n > 0 else 1.0)
        assert e <= rel, f"parameter {si}.{k}: error {e:.2e} of the norm"


def snapshot(jnet):
    return jax.tree.map(lambda a: np.asarray(a).astype(np.float64), jnet.params_)
