"""The port's ``VariationalAutoencoder`` and ``MultiLayerNetwork
.pretrain`` / ``pretrainLayer`` against the JAX package's, on the CPU at
small sizes (an MNIST-shaped net cut to 64 → 16 → latent 4).

The reparameterization's draw comes from threefry on the reference side,
which torch cannot reproduce, so both sides take the reference's draw:
``pretrain_loss(eps=...)`` and ``pretrainLayer(eps=[...])``, one draw a
step, as the reference splits its key. Tolerances (the parity harness's):
f32 loss relative 1e-5 and gradients relative L2 1e-5, f64 1e-12 /
1e-10, bf16 outputs 2e-2; after pretraining (Adam, 3 steps) every param
within atol 1e-5 and each step's score relative 1e-5.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from deeplearning4j_tpu.nn.conf.inputs import InputType as JIT
from deeplearning4j_tpu_torch.nn.conf import layers as TL

from _torch_parity import (TOL, assert_close, check_round_trip, pair,
                           params_of, rel_l2, run_both, x64)

RNG = np.random.default_rng(21)
IT = JIT.feed_forward(12)
X = RNG.uniform(0, 1, (5, 12))


def _vae(dist="gaussian", samples=1, **kw):
    return pair("VariationalAutoencoder", IT, n_out=3,
                encoder_layer_sizes=(8, 6), decoder_layer_sizes=(7,),
                reconstruction_distribution=dist, num_samples=samples,
                activation="tanh", **kw)


@pytest.mark.parametrize("dtype", ["float32", "float64", "bfloat16"])
@pytest.mark.parametrize("dist", ["gaussian", "bernoulli"])
def test_encoder_forward_matches_reference(dist, dtype):
    """The supervised forward emits the posterior mean."""
    j, t = _vae(dist)
    assert list(t.param_shapes().items()) == list(j.param_shapes().items())
    ref, port = run_both(j, t, params_of(j, 1), X, dtype)
    assert_close(ref, port, dtype)


def _pretrain_both(j, t, params, x, key, dtype):
    """(loss, param grads) of both sides' pretrain_loss on the reference's
    draw for ``key``."""
    with x64(dtype):
        dt = jnp.float64 if dtype == "float64" else jnp.float32
        jp = {k: jnp.asarray(v, dt) for k, v in params.items()}
        val, g = jax.value_and_grad(
            lambda p: j.pretrain_loss(p, jnp.asarray(x, dt), key))(jp)
        mean_shape = (x.shape[0], j.n_out)
        eps = np.asarray(jax.random.normal(key, (j.num_samples,) + mean_shape,
                                           dt), np.float64)
        ref = (float(val), {k: np.asarray(v, np.float64)
                            for k, v in g.items()})
    tdt = getattr(torch, dtype)
    tp = {k: torch.tensor(v, dtype=tdt, requires_grad=True)
          for k, v in params.items()}
    loss = t.pretrain_loss(tp, torch.tensor(x, dtype=tdt),
                           eps=torch.tensor(eps, dtype=tdt))
    grads = torch.autograd.grad(loss, list(tp.values()))
    return ref, (float(loss), {k: gi.double().numpy()
                               for k, gi in zip(tp, grads)})


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("dist,samples", [("gaussian", 1), ("gaussian", 3),
                                          ("bernoulli", 1), ("bernoulli", 2)])
def test_pretrain_loss_matches_reference_on_its_draw(dist, samples, dtype):
    j, t = _vae(dist, samples)
    ref, port = _pretrain_both(j, t, params_of(j, 2), X,
                               jax.random.PRNGKey(samples), dtype)
    tol = TOL[dtype]
    assert abs(port[0] - ref[0]) <= tol[0] * abs(ref[0])
    for k in ref[1]:
        assert rel_l2(port[1][k], ref[1][k]) <= tol[1], k


def test_pretrain_loss_draws_from_the_generator():
    """Without ``eps`` the draw comes from the generator: the same seed
    gives the same loss, another seed another."""
    _, t = _vae()
    p = {k: torch.tensor(v, dtype=torch.float32)
         for k, v in params_of(t, 3).items()}
    x = torch.tensor(X, dtype=torch.float32)

    def loss(seed):
        return float(t.pretrain_loss(p, x, gen=torch.Generator()
                                     .manual_seed(seed)))

    assert loss(1) == loss(1) != loss(2)


@pytest.mark.parametrize("dist", ["gaussian", "bernoulli"])
def test_reconstruction_surface_matches_reference(dist):
    j, t = _vae(dist)
    params = params_of(j, 4)
    jp = {k: jnp.asarray(v, jnp.float32) for k, v in params.items()}
    tp = {k: torch.tensor(v, dtype=torch.float32) for k, v in params.items()}
    x = X.astype(np.float32)
    z = RNG.standard_normal((5, 3)).astype(np.float32)
    pairs = [(j.reconstruct(jp, jnp.asarray(x)),
              t.reconstruct(tp, torch.tensor(x))),
             (j.generate_at_mean_given_z(jp, jnp.asarray(z)),
              t.generate_at_mean_given_z(tp, torch.tensor(z))),
             (j.reconstruction_error(jp, jnp.asarray(x)),
              t.reconstruction_error(tp, torch.tensor(x)))]
    for want, got in pairs:
        assert rel_l2(got.numpy(), np.asarray(want)) <= 1e-5


def test_config_round_trips():
    j, t = _vae("bernoulli", 2, pzx_activation="tanh")
    check_round_trip(j, t)
    assert t.is_pretrain_layer()


# ------------------------------------------------------------ pretrain
def _nets(dist="bernoulli"):
    """Dense(16) → VAE(16 → 8 → latent 4, ``dist``) → Output(3), Adam."""
    from deeplearning4j_tpu.nn import multilayer as j_mln
    from deeplearning4j_tpu.nn.conf import configuration as j_cfg
    from deeplearning4j_tpu.nn.conf import layers as JL
    from deeplearning4j_tpu.nn.conf import variational as JV
    from deeplearning4j_tpu.optim import updaters as j_upd
    from deeplearning4j_tpu_torch.nn import multilayer as t_mln
    from deeplearning4j_tpu_torch.nn.conf import configuration as t_cfg
    from deeplearning4j_tpu_torch.nn.conf import variational as TV
    from deeplearning4j_tpu_torch.nn.conf.inputs import InputType as TIT
    from deeplearning4j_tpu_torch.optim import updaters as t_upd
    nets = []
    for cfg, L, V, U, typ in ((j_cfg, JL, JV, j_upd, JIT),
                              (t_cfg, TL, TV, t_upd, TIT)):
        conf = (cfg.NeuralNetConfiguration.builder().seed(5)
                .updater(U.Adam(1e-2)).list()
                .layer(L.DenseLayer(n_out=16, activation="relu"))
                .layer(V.VariationalAutoencoder(
                    n_out=4, encoder_layer_sizes=(8,),
                    decoder_layer_sizes=(8,), activation="tanh",
                    reconstruction_distribution=dist))
                .layer(L.OutputLayer(n_out=3, activation="softmax"))
                .set_input_type(typ.feed_forward(10)).build())
        nets.append(conf)
    ref = j_mln.MultiLayerNetwork(nets[0]).init()
    net = t_mln.MultiLayerNetwork(nets[1], device="cpu").init()
    net.set_param_tree(jax.tree.map(np.asarray, ref.param_tree()))
    return ref, net


def _reference_draws(ref, steps, n, latent, samples=1):
    """The reparameterization draws ``pretrainLayer`` makes, one a step:
    the network key split once a step, as the reference's loop does."""
    key, out = ref._key, []
    for _ in range(steps):
        key, sub = jax.random.split(key)
        out.append(np.asarray(jax.random.normal(
            sub, (samples, n, latent), jnp.float32)))
    return out


@pytest.mark.parametrize("dist", ["bernoulli", "gaussian"])
def test_pretrain_layer_matches_reference(dist):
    """Three Adam steps of the VAE's negative ELBO over the dense layer's
    inference activations: every step's score and the VAE's params match
    the reference's; no other layer's params move."""
    ref, net = _nets(dist)
    x = RNG.uniform(0, 1, (6, 10)).astype(np.float32)
    draws = _reference_draws(ref, 3, 6, 4)
    j_scores, t_scores = [], []

    class Rec:
        def __init__(self, out):
            self.out = out

        def iteration_done(self, model, it, epoch, score):
            self.out.append(score)

    ref.setListeners(Rec(j_scores))
    net.setListeners(Rec(t_scores))
    before = {k: {p: v.clone() for p, v in d.items()}
              for k, d in net.param_tree().items()}
    ref.pretrainLayer(1, x, epochs=3)
    net.pretrainLayer(1, x, epochs=3, eps=draws)
    np.testing.assert_allclose(t_scores, j_scores, rtol=1e-5)
    jp = jax.tree.map(np.asarray, ref.param_tree())
    tp = net.param_tree()
    for p in jp["1"]:
        np.testing.assert_allclose(tp["1"][p].numpy(), jp["1"][p],
                                   atol=1e-5, err_msg=p)
        assert not torch.equal(tp["1"][p], before["1"][p]) or p.endswith("b")
    for k in ("0", "2"):
        for p in before[k]:
            assert torch.equal(tp[k][p], before[k][p])
    assert net.getIterationCount() == 3


def test_pretrain_runs_every_pretrainable_layer():
    ref, net = _nets()
    x = RNG.uniform(0, 1, (6, 10)).astype(np.float32)
    w0 = net.param_tree()["1"]["pXZW"].clone()
    net.pretrain(x, epochs=2)
    assert net.getIterationCount() == 2
    assert not torch.equal(net.param_tree()["1"]["pXZW"], w0)
    with pytest.raises(ValueError, match="not pretrainable"):
        net.pretrainLayer(0, x)
