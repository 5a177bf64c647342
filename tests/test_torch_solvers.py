"""The port's ``Solver`` and optimizers (``optim/solvers.py``) against the
JAX package's on the CPU.

A two-layer tanh MLP with the reference's weights runs 5 iterations of
each algorithm (SGD; line gradient descent, conjugate gradient and
L-BFGS with the Armijo backtracking line search) in each package on one
seeded batch. The direction and line-search arithmetic is the same numpy
code on both sides, so only the f32 evaluations differ (~1e-7 relative).
Every line-search trial's Armijo margin (score minus its bound) is
printed and must exceed 100 × the score row below, so no accept or
reject can flip between the packages: where it held, the trajectories
agree — each iteration's score within relative 1e-5 and the final params
within atol 1e-5 (f32 evaluations in another order, carried through at
most 5 steps whose sizes the same branches chose).
"""
import numpy as np
import pytest

import jax

from deeplearning4j_tpu.nn import multilayer as j_mln
from deeplearning4j_tpu.nn.conf import configuration as j_cfg
from deeplearning4j_tpu.nn.conf import inputs as j_inputs
from deeplearning4j_tpu.nn.conf import layers as j_layers
from deeplearning4j_tpu.optim import listeners as j_lst
from deeplearning4j_tpu.optim import solvers as j_sol
from deeplearning4j_tpu.optim import updaters as j_upd
from deeplearning4j_tpu_torch.nn import multilayer as t_mln
from deeplearning4j_tpu_torch.nn.conf import configuration as t_cfg
from deeplearning4j_tpu_torch.nn.conf import inputs as t_inputs
from deeplearning4j_tpu_torch.nn.conf import layers as t_layers
from deeplearning4j_tpu_torch.optim import listeners as t_lst
from deeplearning4j_tpu_torch.optim import solvers as t_sol
from deeplearning4j_tpu_torch.optim import updaters as t_upd

J = dict(cfg=j_cfg, L=j_layers, IT=j_inputs.InputType, U=j_upd, sol=j_sol,
         lst=j_lst, MLN=j_mln.MultiLayerNetwork)
P = dict(cfg=t_cfg, L=t_layers, IT=t_inputs.InputType, U=t_upd, sol=t_sol,
         lst=t_lst, MLN=t_mln.MultiLayerNetwork)
SCORE_REL = 1e-5
PARAM_ATOL = 1e-5
ITERS = 5
SCALE = 6


def conf(ns):
    L = ns["L"]
    return (ns["cfg"].NeuralNetConfiguration.builder().seed(8)
            .updater(ns["U"].Sgd(0.1)).weight_init("xavier").list()
            .layer(L.DenseLayer(n_out=10, activation="tanh"))
            .layer(L.OutputLayer(n_out=3, activation="softmax",
                                 loss_function="mcxent"))
            .set_input_type(ns["IT"].feed_forward(4)).build())


def batch(seed=1, n=32):
    rng = np.random.default_rng(seed)
    x = (SCALE * rng.standard_normal((n, 4))).astype(np.float32)
    cls = (x[:, 0] + 0.5 * x[:, 1] > 0).astype(int) + (x[:, 2] > 1).astype(int)
    return x, np.eye(3, dtype=np.float32)[cls]


def run(ns, algo, ref=None):
    net = ns["MLN"](conf(ns)).init() if ns is J else ns["MLN"](
        conf(ns), device="cpu").init()
    if ref is not None:
        net.set_param_tree(jax.tree.map(np.asarray, ref.param_tree()))
        net.set_updater_state_from_jax(jax.tree.map(np.asarray,
                                                    ref._opt_state))
    scores = ns["lst"].CollectScoresListener()
    net.setListeners(scores)
    solver = (ns["sol"].Solver.Builder().model(net).configure(algo)
              .max_iterations(ITERS).build())
    x, y = batch()
    if algo == "sgd":
        for _ in range(ITERS):
            solver.optimize(x, y)
    else:
        solver.optimize(x, y)
    return net, scores.scores, solver.optimizer


def _flat(net):
    p = net.params()
    return np.asarray(p.buf() if hasattr(p, "buf") else p.numpy())


@pytest.mark.parametrize("algo", ["sgd", "line_gradient_descent",
                                  "conjugate_gradient", "lbfgs"])
def test_solver_matches_reference(algo, capsys):
    j_net, j_scores, _ = run(J, algo)
    ref0 = J["MLN"](conf(J)).init()
    t_net, t_scores, opt = run(P, algo, ref=ref0)
    if algo != "sgd":
        margins = [(it, alpha, score - bound)
                   for it, alpha, score, bound in opt.trials]
        with capsys.disabled():
            print(f"\n{algo} Armijo margins (iteration, step, score - bound):",
                  [(i, a, f"{m:.3e}") for i, a, m in margins])
        assert margins
        for it, alpha, m in margins:
            assert abs(m) > 100 * SCORE_REL, (it, alpha, m)
    assert len(t_scores) == len(j_scores) == ITERS
    for a, b in zip(t_scores, j_scores):
        assert abs(a - b) <= SCORE_REL * max(1.0, abs(b))
    assert t_scores[-1] < t_scores[0]
    np.testing.assert_allclose(_flat(t_net), _flat(j_net), atol=PARAM_ATOL)
    assert t_net.getIterationCount() == j_net.getIterationCount() == ITERS


def test_solver_without_an_acceptable_step_restores_the_params():
    net = P["MLN"](conf(P), device="cpu").init()
    opt = t_sol.LineGradientDescent(net, max_iterations=3)
    x, y = batch()
    before = net.params().buf().clone()
    # a direction uphill: no step meets the Armijo bound
    f0, g = t_sol._score_and_flat_grad(net, x, y)
    alpha, score = opt._line_search(x, y, g, f0, g, max_steps=4)
    assert (alpha, score) == (0.0, f0)
    assert len(opt.trials) == 4 and all(s > b for _, _, s, b in opt.trials)
    assert bool((net.params() == before).all())
    with pytest.raises(KeyError):
        t_sol.Solver(net, "newton")
