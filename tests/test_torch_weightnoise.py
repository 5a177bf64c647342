"""The port's weight noise (``nn/weightnoise.py``: ``DropConnect``,
``WeightNoise``, ``noise_from_dict``) against the JAX package's, on the
CPU at small sizes.

The reference draws its masks and noise from threefry, which torch cannot
reproduce. So each scheme is held two ways: by its distribution (the kept
share within 5σ of p and kept weights exactly w / p; the noise's mean and
standard deviation within 5σ of theirs), and by its function on the
reference's own draws, fed to the port's ``apply(draws=...)``: then the
noisy params, a network's loss and its gradients match the reference's
(f32 relative 1e-5, gradients relative L2 1e-5).
"""
import math

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from deeplearning4j_tpu.nn import weightnoise as JW
from deeplearning4j_tpu_torch.nn import weightnoise as TW
from deeplearning4j_tpu_torch.nn.conf import layers as TL

from _torch_parity import rel_l2

RNG = np.random.default_rng(31)


def _reference_draws(scheme, params, key, layer=None):
    """The draws the reference's ``apply(params, key)`` makes: for each
    param in sorted order that it perturbs, fold_in(key, its index) into a
    Bernoulli keep mask (DropConnect) or a standard normal (WeightNoise)."""
    draws = {}
    for i, (k, w) in enumerate(sorted(params.items())):
        if k in getattr(layer, "non_weight_params", ()):
            continue
        if not (scheme.apply_to_bias or np.ndim(w) >= 2):
            continue
        sub = jax.random.fold_in(key, i)
        if isinstance(scheme, JW.DropConnect):
            draws[k] = np.asarray(jax.random.bernoulli(sub, scheme.p,
                                                       np.shape(w)))
        else:
            draws[k] = np.asarray(jax.random.normal(sub, np.shape(w),
                                                    jnp.float32))
    return draws


SCHEMES = [("DropConnect", dict(p=0.7)),
           ("DropConnect", dict(p=0.5, apply_to_bias=True)),
           ("WeightNoise", dict(std=0.1)),
           ("WeightNoise", dict(std=0.2, additive=False, apply_to_bias=True))]


@pytest.mark.parametrize("kind,kw", SCHEMES, ids=lambda v: str(v))
def test_function_on_the_reference_draws(kind, kw):
    j, t = getattr(JW, kind)(**kw), getattr(TW, kind)(**kw)
    layer = TL.CenterLossOutputLayer(n_in=4, n_out=3)
    params = {"W": RNG.standard_normal((4, 3)).astype(np.float32),
              "b": RNG.standard_normal(3).astype(np.float32),
              "centers": RNG.standard_normal((3, 4)).astype(np.float32)}
    key = jax.random.PRNGKey(3)
    want = j.apply({k: jnp.asarray(v) for k, v in params.items()}, key,
                   layer=layer)
    draws = {k: torch.tensor(v) for k, v in
             _reference_draws(j, params, key, layer).items()}
    assert "centers" not in draws
    got = t.apply({k: torch.tensor(v) for k, v in params.items()}, None,
                  layer=layer, draws=draws)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-6, atol=1e-7, err_msg=k)
    assert torch.equal(got["centers"], torch.tensor(params["centers"]))


def test_drop_connect_keeps_its_share():
    t = TW.DropConnect(p=0.6)
    w = torch.ones(200, 300)
    out = t.apply({"W": w, "b": torch.ones(300)},
                  torch.Generator().manual_seed(0))
    kept = out["W"] != 0
    assert bool((out["W"][kept] == 1 / 0.6).all())
    n = kept.numel()
    assert abs(float(kept.float().mean()) - 0.6) <= 5 * math.sqrt(
        0.6 * 0.4 / n)
    assert torch.equal(out["b"], torch.ones(300))


@pytest.mark.parametrize("additive", [True, False])
def test_weight_noise_moments(additive):
    t = TW.WeightNoise(std=0.05, additive=additive)
    w = torch.full((300, 300), 2.0)
    out = t.apply({"W": w}, torch.Generator().manual_seed(1))["W"]
    z = (out - w) / (0.05 if additive else 0.05 * 2.0)
    n = z.numel()
    assert abs(float(z.mean())) <= 5 / math.sqrt(n)
    assert abs(float(z.std()) - 1.0) <= 5 * math.sqrt(2 / n)


def test_configs_round_trip_across_packages():
    for kind, kw in SCHEMES:
        j, t = getattr(JW, kind)(**kw), getattr(TW, kind)(**kw)
        assert t.to_dict() == j.to_dict()
        assert TW.noise_from_dict(j.to_dict()) == t
        assert JW.noise_from_dict(t.to_dict()).to_dict() == j.to_dict()
    assert TW.noise_from_dict(None) is None


# ------------------------------------------------------------ networks
def _nets(scheme_kind, graph=False):
    """Dense(8, DropConnect or WeightNoise) → Output(3): the same conf on
    both sides, the reference's params carried over."""
    from deeplearning4j_tpu.nn import graph as j_graph
    from deeplearning4j_tpu.nn import multilayer as j_mln
    from deeplearning4j_tpu.nn.conf import configuration as j_cfg
    from deeplearning4j_tpu.nn.conf import layers as JL
    from deeplearning4j_tpu.nn.conf.inputs import InputType as JIT
    from deeplearning4j_tpu_torch.nn import graph as t_graph
    from deeplearning4j_tpu_torch.nn import multilayer as t_mln
    from deeplearning4j_tpu_torch.nn.conf import configuration as t_cfg
    from deeplearning4j_tpu_torch.nn.conf.inputs import InputType as TIT
    kind, kw = scheme_kind
    out = []
    for cfg, L, W, typ, mods in ((j_cfg, JL, JW, JIT, (j_mln, j_graph)),
                                 (t_cfg, TL, TW, TIT, (t_mln, t_graph))):
        b = cfg.NeuralNetConfiguration.builder().seed(7)
        hidden = L.DenseLayer(n_out=8, activation="tanh",
                              weight_noise=getattr(W, kind)(**kw))
        head = L.OutputLayer(n_out=3, activation="softmax")
        if graph:
            g = (b.graph_builder().add_inputs("in")
                 .set_input_types(typ.feed_forward(5)))
            g.add_layer("h", hidden, "in").add_layer("out", head, "h")
            conf = g.set_outputs("out").build()
            out.append(conf)
        else:
            out.append(b.list().layer(hidden).layer(head)
                       .set_input_type(typ.feed_forward(5)).build())
    if graph:
        ref = j_graph.ComputationGraph(out[0]).init()
        net = t_graph.ComputationGraph(out[1], device="cpu").init()
    else:
        ref = j_mln.MultiLayerNetwork(out[0]).init()
        net = t_mln.MultiLayerNetwork(out[1], device="cpu").init()
    net.set_param_tree(jax.tree.map(np.asarray, ref.param_tree()))
    return ref, net


@pytest.mark.parametrize("graph", [False, True], ids=["mln", "graph"])
@pytest.mark.parametrize("scheme", SCHEMES[::2], ids=["dropconnect",
                                                      "weightnoise"])
def test_network_loss_on_the_reference_draws(scheme, graph):
    """The training loss and gradients of a net whose hidden layer carries
    weight noise, on the draws the reference's forward walk makes
    (fold_in(fold_in(rng, layer index), 7919)); the output layer's loss
    takes its params un-noised, as the reference's."""
    ref, net = _nets(scheme, graph)
    x = RNG.standard_normal((6, 5)).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[RNG.integers(0, 3, 6)]
    rng = jax.random.PRNGKey(11)
    jp = ref.param_tree()
    hkey = "h" if graph else "0"
    li = ref.conf.topo_order.index("h") if graph else 0
    lrng = jax.random.fold_in(jax.random.fold_in(rng, li), 7919)
    hidden = (ref.conf.nodes["h"].layer if graph else ref.layers[0])
    draws = {k: torch.tensor(v) for k, v in _reference_draws(
        hidden.weight_noise, jax.tree.map(np.asarray, jp[hkey]), lrng).items()}
    if graph:
        args = (jp, ref.state_tree(), (jnp.asarray(x),), (jnp.asarray(y),),
                None, None, rng)
    else:
        args = (jp, ref.state_tree(), jnp.asarray(x), jnp.asarray(y), None,
                None, rng)
    (j_loss, _), j_grads = jax.value_and_grad(ref._loss_fn, has_aux=True)(
        *args)
    tlayer = (net.conf.nodes["h"].layer if graph else net.layers[0])
    scheme_obj = tlayer.weight_noise

    class Fed(type(scheme_obj)):
        def apply(self, params, gen, layer=None, draws_=None):
            return super().apply(params, gen, layer, draws=draws)

    tlayer.weight_noise = Fed(**{k: getattr(scheme_obj, k)
                                 for k in scheme_obj.to_dict()
                                 if k != "@noise"})
    t_loss, t_grads = net.computeGradientAndScore(x, y)
    assert abs(t_loss - float(j_loss)) <= 1e-5 * abs(float(j_loss))
    for k in j_grads:
        for p in j_grads[k]:
            assert rel_l2(t_grads[k][p].numpy(),
                          np.asarray(j_grads[k][p])) <= 1e-5, (k, p)


@pytest.mark.parametrize("scheme", SCHEMES[::2], ids=["dropconnect",
                                                      "weightnoise"])
def test_noise_acts_in_training_only(scheme):
    """A net with weight noise initialises (the port refused it before),
    fits, and infers without noise: output() equals the noise-free
    reference forward; two training forwards differ."""
    ref, net = _nets(scheme)
    x = RNG.standard_normal((6, 5)).astype(np.float32)
    np.testing.assert_allclose(net.output(x).numpy(),
                               np.asarray(ref.output(x)), rtol=1e-5,
                               atol=1e-6)
    a = net.feedForward(x, train=True)[-1]
    b = net.feedForward(x, train=True)[-1]
    assert not torch.equal(a, b)
    y = np.eye(3, dtype=np.float32)[RNG.integers(0, 3, 6)]
    net.fit(x, y)
    assert math.isfinite(net.score())
