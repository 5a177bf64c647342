"""Early stopping: counterpart of ``deeplearning4j_tpu/optim/earlystopping.py``
(ref: org.deeplearning4j.earlystopping.*, SURVEY D14).

``EarlyStoppingConfiguration`` + ``EarlyStoppingTrainer`` with score
calculators, epoch/iteration termination conditions, and model savers —
the same decomposition as the reference. ``InMemoryModelSaver`` keeps
``clone()``s, which (as the reference's) carry params and states but not
the updater state or the frozen set (ROADMAP queue 3);
``LocalFileModelSaver`` writes ``bestModel.bin`` / ``latestModel.bin`` zips
and restores them onto the card unless given ``device="cpu"``.
"""
from __future__ import annotations

import os
import time
from typing import List, Optional


# ------------------------------------------------------------ score calcs
class ScoreCalculator:
    """ref: earlystopping.scorecalc.ScoreCalculator — lower is better by
    default (minimize_score)."""

    minimize_score = True

    def calculate_score(self, network) -> float:
        raise NotImplementedError


class DataSetLossCalculator(ScoreCalculator):
    """Average loss over an iterator (ref: scorecalc.DataSetLossCalculator)."""

    def __init__(self, iterator, average: bool = True):
        self.iterator = iterator
        self.average = average

    def calculate_score(self, network) -> float:
        total, n = 0.0, 0
        if hasattr(self.iterator, "reset"):
            self.iterator.reset()
        for ds in self.iterator:
            total += network.score(ds)
            n += 1
        if n == 0:
            raise ValueError("empty scoring iterator")
        return total / n if self.average else total


class ClassificationScoreCalculator(ScoreCalculator):
    """Maximize accuracy/f1 (ref: scorecalc.ClassificationScoreCalculator)."""

    minimize_score = False

    def __init__(self, iterator, metric: str = "accuracy"):
        self.iterator = iterator
        self.metric = metric

    def calculate_score(self, network) -> float:
        if hasattr(self.iterator, "reset"):
            self.iterator.reset()
        ev = network.evaluate(self.iterator)
        return float(getattr(ev, self.metric)())


# --------------------------------------------------- termination conditions
class EpochTerminationCondition:
    def terminate(self, epoch: int, score: float, minimize: bool) -> bool:
        raise NotImplementedError


class MaxEpochsTerminationCondition(EpochTerminationCondition):
    def __init__(self, max_epochs: int):
        self.max_epochs = max_epochs

    def terminate(self, epoch, score, minimize):
        return epoch >= self.max_epochs - 1


class ScoreImprovementEpochTerminationCondition(EpochTerminationCondition):
    """Stop after N epochs without (sufficient) improvement
    (ref: termination.ScoreImprovementEpochTerminationCondition)."""

    def __init__(self, max_epochs_without_improvement: int,
                 min_improvement: float = 0.0):
        self.patience = max_epochs_without_improvement
        self.min_improvement = min_improvement
        self._best: Optional[float] = None
        self._stale = 0

    def terminate(self, epoch, score, minimize):
        if self._best is None:
            self._best = score
            return False
        improved = ((self._best - score) if minimize else (score - self._best)) \
            > self.min_improvement
        if improved:
            self._best = score
            self._stale = 0
        else:
            self._stale += 1
        return self._stale >= self.patience


class BestScoreEpochTerminationCondition(EpochTerminationCondition):
    """Stop once the score is at least this good (ref: same name)."""

    def __init__(self, best_expected: float):
        self.best_expected = best_expected

    def terminate(self, epoch, score, minimize):
        return score <= self.best_expected if minimize \
            else score >= self.best_expected


class IterationTerminationCondition:
    def terminate(self, score: float) -> bool:
        raise NotImplementedError


class MaxTimeIterationTerminationCondition(IterationTerminationCondition):
    def __init__(self, max_seconds: float):
        self.max_seconds = max_seconds
        self._start = None

    def initialize(self):
        self._start = time.time()

    def terminate(self, score):
        if self._start is None:
            self.initialize()
        return time.time() - self._start > self.max_seconds


class MaxScoreIterationTerminationCondition(IterationTerminationCondition):
    """Abort when the score explodes (ref: same name)."""

    def __init__(self, max_score: float):
        self.max_score = max_score

    def terminate(self, score):
        return score > self.max_score or score != score  # NaN guard


# ------------------------------------------------------------------ savers
class InMemoryModelSaver:
    def __init__(self):
        self._best = None
        self._latest = None

    def save_best_model(self, net, score):
        self._best = net.clone()

    def save_latest_model(self, net, score):
        self._latest = net.clone()

    def get_best_model(self):
        return self._best

    def get_latest_model(self):
        return self._latest


class LocalFileModelSaver:
    """ref: earlystopping.saver.LocalFileModelSaver — bestModel.bin /
    latestModel.bin in a directory. The getters restore onto the device
    of the net that was saved, unless a call names another (a model this
    saver did not write restores onto the card)."""

    def __init__(self, directory: str):
        self.directory = directory
        self._devices = {}
        os.makedirs(directory, exist_ok=True)

    def _path(self, kind):
        return os.path.join(self.directory, f"{kind}Model.bin")

    def _save(self, kind, net):
        net.save(self._path(kind))
        self._devices[kind] = net.device

    def _restore(self, kind, device):
        from deeplearning4j_tpu_torch.utils.serialization import (
            ModelSerializer)
        return ModelSerializer.restore(
            self._path(kind), device=device or self._devices.get(kind))

    def save_best_model(self, net, score):
        self._save("best", net)

    def save_latest_model(self, net, score):
        self._save("latest", net)

    def get_best_model(self, device=None):
        return self._restore("best", device)

    def get_latest_model(self, device=None):
        return self._restore("latest", device)

    getBestModel = get_best_model
    getLatestModel = get_latest_model


# ------------------------------------------------------------------- config
class EarlyStoppingConfiguration:
    """ref: earlystopping.EarlyStoppingConfiguration (+ .Builder)."""

    def __init__(self, score_calculator: ScoreCalculator,
                 epoch_termination_conditions: List[EpochTerminationCondition] = (),
                 iteration_termination_conditions: List[IterationTerminationCondition] = (),
                 model_saver=None, evaluate_every_n_epochs: int = 1,
                 save_last_model: bool = False):
        self.score_calculator = score_calculator
        self.epoch_conditions = list(epoch_termination_conditions)
        self.iteration_conditions = list(iteration_termination_conditions)
        self.model_saver = model_saver or InMemoryModelSaver()
        self.evaluate_every_n_epochs = evaluate_every_n_epochs
        self.save_last_model = save_last_model

    class Builder:
        def __init__(self):
            self._kw = {"epoch_termination_conditions": [],
                        "iteration_termination_conditions": []}

        def score_calculator(self, sc):
            self._kw["score_calculator"] = sc
            return self

        scoreCalculator = score_calculator

        def epoch_termination_conditions(self, *conds):
            self._kw["epoch_termination_conditions"].extend(conds)
            return self

        epochTerminationConditions = epoch_termination_conditions

        def iteration_termination_conditions(self, *conds):
            self._kw["iteration_termination_conditions"].extend(conds)
            return self

        iterationTerminationConditions = iteration_termination_conditions

        def model_saver(self, saver):
            self._kw["model_saver"] = saver
            return self

        modelSaver = model_saver

        def evaluate_every_n_epochs(self, n):
            self._kw["evaluate_every_n_epochs"] = n
            return self

        evaluateEveryNEpochs = evaluate_every_n_epochs

        def save_last_model(self, b=True):
            self._kw["save_last_model"] = b
            return self

        def build(self):
            return EarlyStoppingConfiguration(**self._kw)


class EarlyStoppingResult:
    """ref: earlystopping.EarlyStoppingResult."""

    def __init__(self, termination_reason, termination_details, score_vs_epoch,
                 best_model_epoch, best_model_score, total_epochs, best_model):
        self.termination_reason = termination_reason
        self.termination_details = termination_details
        self.score_vs_epoch = score_vs_epoch
        self.best_model_epoch = best_model_epoch
        self.best_model_score = best_model_score
        self.total_epochs = total_epochs
        self.best_model = best_model

    def get_best_model(self):
        return self.best_model

    getBestModel = get_best_model


class EarlyStoppingTrainer:
    """Train epoch-by-epoch, score on the validation calculator, stop per
    the configured conditions (ref: trainer.EarlyStoppingTrainer)."""

    def __init__(self, config: EarlyStoppingConfiguration, network, train_data):
        self.config = config
        self.network = network
        self.train_data = train_data

    def fit(self) -> EarlyStoppingResult:
        cfg = self.config
        minimize = cfg.score_calculator.minimize_score
        best_score, best_epoch = None, -1
        scores = {}
        reason, details = "MaxEpochs", "loop exhausted"
        epoch = -1
        for cond in cfg.iteration_conditions:
            if hasattr(cond, "initialize"):
                cond.initialize()
        max_epochs = max((c.max_epochs for c in cfg.epoch_conditions
                          if isinstance(c, MaxEpochsTerminationCondition)),
                         default=10_000)
        stop = False
        for epoch in range(max_epochs):
            if hasattr(self.train_data, "reset"):
                self.train_data.reset()
            self.network.fit(self.train_data, epochs=1)
            # iteration-level conditions checked against the training score
            # (score() is a sync point: it materializes a loss the async
            # fit loop may have left on device)
            tscore = (self.network.score()
                      if callable(getattr(self.network, "score", None))
                      else getattr(self.network, "_score", float("nan")))
            for cond in cfg.iteration_conditions:
                if cond.terminate(tscore):
                    reason = "IterationTerminationCondition"
                    details = type(cond).__name__
                    stop = True
            if stop:
                break
            if (epoch + 1) % cfg.evaluate_every_n_epochs == 0:
                score = cfg.score_calculator.calculate_score(self.network)
                scores[epoch] = score
                better = (best_score is None
                          or (score < best_score if minimize
                              else score > best_score))
                if better:
                    best_score, best_epoch = score, epoch
                    cfg.model_saver.save_best_model(self.network, score)
                if cfg.save_last_model:
                    cfg.model_saver.save_latest_model(self.network, score)
                for cond in cfg.epoch_conditions:
                    if cond.terminate(epoch, score, minimize):
                        reason = ("MaxEpochs"
                                  if isinstance(cond, MaxEpochsTerminationCondition)
                                  else "EpochTerminationCondition")
                        details = type(cond).__name__
                        stop = True
                if stop:
                    break
        best = cfg.model_saver.get_best_model() or self.network
        return EarlyStoppingResult(
            termination_reason=reason, termination_details=details,
            score_vs_epoch=scores, best_model_epoch=best_epoch,
            best_model_score=best_score, total_epochs=epoch + 1,
            best_model=best)


# alias matching the reference's graph trainer
EarlyStoppingGraphTrainer = EarlyStoppingTrainer
