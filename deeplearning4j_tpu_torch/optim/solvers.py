"""Solver and the convex-style optimizers: counterpart of
``deeplearning4j_tpu/optim/solvers.py`` (ref:
``org.deeplearning4j.optimize.Solver`` and
``org.deeplearning4j.optimize.solvers.{BaseOptimizer,
StochasticGradientDescent,LineGradientDescent,ConjugateGradient,LBFGS}`` —
SURVEY D5).

SGD is the net's own train step. The line-search, conjugate-gradient and
L-BFGS optimizers keep the reference's split: the direction and the
Armijo line search run on the flat parameter vector on the host in numpy,
with the reference's arithmetic (f32 vectors, Python-float scalars), and
each score and gradient is one call of ``computeGradientAndScore`` on the
net's device, fetched with one copy. Only the evaluations differ from
the JAX package's. Each optimizer records its line search's trials
(``trials``: iteration, step, score, Armijo bound), so a caller can see
how far each accept or reject sat from its bound.
"""
from __future__ import annotations

import numpy as np

from deeplearning4j_tpu_torch.nn import params as _flat


def _score_and_flat_grad(net, x, y):
    score, grads = net.computeGradientAndScore(x, y)
    return score, _flat.flatten_params(grads).cpu().numpy()


def _set_flat(net, vec: np.ndarray):
    net.setParams(np.asarray(vec, np.float32))


def _get_flat(net) -> np.ndarray:
    return net.params().buf().cpu().numpy()


class BaseOptimizer:
    """ref: solvers.BaseOptimizer — iteration loop + listener dispatch."""

    def __init__(self, net, max_iterations: int = 10):
        self.net = net
        self.max_iterations = max_iterations
        #: (iteration, step, score, Armijo bound) of every line-search trial
        self.trials = []

    def optimize(self, x, y) -> bool:
        raise NotImplementedError

    def _iteration_done(self, score):
        net = self.net
        # drop any deferred device-side loss a prior fit left behind: a
        # later score() must not overwrite this fresh value with it
        net._pending_score = None
        net._score = float(score)
        net._iteration += 1
        for lst in net._listeners:
            lst.iteration_done(net, net._iteration, net._epoch, net._score)

    def _line_search(self, x, y, p, f0, g0, alpha0=1.0, c1=1e-4,
                     shrink=0.5, max_steps=20):
        """Armijo backtracking along direction p from the current params
        (ref: solvers.BackTrackLineSearch); returns (step, score), step 0
        and the params restored where no step is acceptable."""
        net = self.net
        theta0 = _get_flat(net)
        slope = float(g0 @ p)
        alpha = alpha0
        for _ in range(max_steps):
            _set_flat(net, theta0 + alpha * p)
            score, _ = net.computeGradientAndScore(x, y)
            bound = f0 + c1 * alpha * slope
            self.trials.append((net._iteration, alpha, score, bound))
            if score <= bound:
                return alpha, score
            alpha *= shrink
        _set_flat(net, theta0)     # no acceptable step
        return 0.0, f0


class StochasticGradientDescent(BaseOptimizer):
    """ref: solvers.StochasticGradientDescent — one updater step per call:
    the net's train step (forward, backward, updater)."""

    def optimize(self, x, y) -> bool:
        self.net._fit_batch(*self.net._xy_args(x, y))
        return True


class LineGradientDescent(BaseOptimizer):
    """ref: solvers.LineGradientDescent — steepest descent + line search."""

    def optimize(self, x, y) -> bool:
        for _ in range(self.max_iterations):
            f0, g = _score_and_flat_grad(self.net, x, y)
            p = -g
            alpha, score = self._line_search(x, y, p, f0, g)
            if alpha == 0.0:
                self._iteration_done(f0)
                return False
            self._iteration_done(score)
        return True


class ConjugateGradient(BaseOptimizer):
    """ref: solvers.ConjugateGradient — Polak-Ribière nonlinear CG with
    automatic restart when the direction loses descent."""

    def optimize(self, x, y) -> bool:
        f0, g = _score_and_flat_grad(self.net, x, y)
        p = -g
        for _ in range(self.max_iterations):
            if float(g @ p) >= 0:      # not a descent direction → restart
                p = -g
            alpha, score = self._line_search(x, y, p, f0, g)
            if alpha == 0.0:
                self._iteration_done(f0)
                return False
            f1, g_new = _score_and_flat_grad(self.net, x, y)
            beta = max(0.0, float(g_new @ (g_new - g)) /
                       max(float(g @ g), 1e-12))   # PR+
            p = -g_new + beta * p
            g, f0 = g_new, f1
            self._iteration_done(score)
        return True


class LBFGS(BaseOptimizer):
    """ref: solvers.LBFGS — limited-memory BFGS (two-loop recursion, history
    ``m``) with Armijo line search on the flat vector."""

    def __init__(self, net, max_iterations: int = 10, m: int = 10):
        super().__init__(net, max_iterations)
        self.m = m

    def optimize(self, x, y) -> bool:
        s_hist, y_hist = [], []
        f0, g = _score_and_flat_grad(self.net, x, y)
        theta = _get_flat(self.net)
        for _ in range(self.max_iterations):
            # two-loop recursion
            q = g.copy()
            alphas = []
            for s, yv in reversed(list(zip(s_hist, y_hist))):
                rho = 1.0 / max(float(yv @ s), 1e-12)
                a = rho * float(s @ q)
                alphas.append((a, rho, s, yv))
                q = q - a * yv
            if y_hist:
                s, yv = s_hist[-1], y_hist[-1]
                q = q * (float(s @ yv) / max(float(yv @ yv), 1e-12))
            for a, rho, s, yv in reversed(alphas):
                b = rho * float(yv @ q)
                q = q + (a - b) * s
            p = -q
            alpha, score = self._line_search(x, y, p, f0, g)
            if alpha == 0.0:
                self._iteration_done(f0)
                return False
            theta_new = _get_flat(self.net)
            f1, g_new = _score_and_flat_grad(self.net, x, y)
            s_hist.append(theta_new - theta)
            y_hist.append(g_new - g)
            if len(s_hist) > self.m:
                s_hist.pop(0)
                y_hist.pop(0)
            theta, g, f0 = theta_new, g_new, f1
            self._iteration_done(score)
        return True


_ALGOS = {
    "sgd": StochasticGradientDescent,
    "stochastic_gradient_descent": StochasticGradientDescent,
    "line_gradient_descent": LineGradientDescent,
    "conjugate_gradient": ConjugateGradient,
    "lbfgs": LBFGS,
}


class Solver:
    """ref: org.deeplearning4j.optimize.Solver (+ .Builder): chooses the
    optimization algorithm and drives it."""

    def __init__(self, net, algorithm: str = "sgd",
                 max_iterations: int = 10):
        cls = _ALGOS[algorithm.lower()]
        self.optimizer = cls(net, max_iterations=max_iterations)

    def optimize(self, x, y) -> bool:
        return self.optimizer.optimize(x, y)

    class Builder:
        def __init__(self):
            self._net = None
            self._algo = "sgd"
            self._iters = 10

        def model(self, net):
            self._net = net
            return self

        def configure(self, algorithm: str):
            self._algo = algorithm
            return self

        def max_iterations(self, n: int):
            self._iters = n
            return self

        def build(self) -> "Solver":
            return Solver(self._net, self._algo, self._iters)
