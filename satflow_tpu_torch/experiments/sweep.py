"""Hyperparameter sweeps, counterpart of ``satflow_tpu/experiments/sweep.py``.

The port's own copy of the JAX module (numpy only, no framework), driving
:func:`satflow_tpu_torch.experiments.train.train` per trial. The JAX
module's description follows.

Hyperparameter sweeps (the reference's hydra-optuna sweeper surface).

The reference uses the hydra-optuna TPE sweeper with search spaces in
``configs/hparams_search/*.yaml`` (reference
satflow/configs/hparams_search/perceiver_optuna.yaml:44-90, sampler
``optuna.samplers.TPESampler``) and re-enters ``main`` per trial under hydra
multirun. Here a self-contained **Tree-structured Parzen Estimator** sampler
(Bergstra et al. 2011, the same algorithm TPESampler implements) runs trials
in-process: each trial overrides dotted config keys, runs ``train``, and the
best ``optimized_metric`` wins. Search-space spec per key:

    model.lr:      {type: loguniform, low: 1e-5, high: 1e-2}
    model.hidden:  {type: categorical, choices: [32, 64, 128]}
    trainer.x:     {type: int, low: 1, high: 8}
    model.p:       {type: uniform, low: 0.0, high: 0.5}

``type: float`` is accepted as an alias of ``uniform`` for reference-YAML parity.
"""

from __future__ import annotations

import copy
import json
import math
import os
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from satflow_tpu_torch.core.config import _set_dotted
from satflow_tpu_torch.core.utils import get_logger

log = get_logger(__name__)


def sample_params(space: Dict[str, Any], rng: np.random.Generator) -> Dict[str, Any]:
    params = {}
    for key, spec in space.items():
        kind = spec.get("type", "uniform")
        if kind == "loguniform":
            lo, hi = math.log(spec["low"]), math.log(spec["high"])
            params[key] = float(math.exp(rng.uniform(lo, hi)))
        elif kind in ("uniform", "float"):
            params[key] = float(rng.uniform(spec["low"], spec["high"]))
        elif kind == "int":
            params[key] = int(rng.integers(spec["low"], spec["high"] + 1))
        elif kind == "categorical":
            params[key] = spec["choices"][int(rng.integers(len(spec["choices"])))]
        else:
            raise ValueError(f"Unknown search-space type {kind!r} for {key}")
    return params


# -- TPE sampler ---------------------------------------------------------------


def _to_unit(value: float, spec: Dict[str, Any]) -> float:
    """Map a numeric param into [0, 1] (log-scaled for loguniform)."""
    if spec.get("type") == "loguniform":
        lo, hi = math.log(spec["low"]), math.log(spec["high"])
        return (math.log(value) - lo) / max(hi - lo, 1e-12)
    lo, hi = float(spec["low"]), float(spec["high"])
    return (value - lo) / max(hi - lo, 1e-12)


def _from_unit(u: float, spec: Dict[str, Any]):
    u = min(max(u, 0.0), 1.0)
    if spec.get("type") == "loguniform":
        lo, hi = math.log(spec["low"]), math.log(spec["high"])
        return float(math.exp(lo + u * (hi - lo)))
    lo, hi = float(spec["low"]), float(spec["high"])
    x = lo + u * (hi - lo)
    if spec.get("type") == "int":
        return int(round(min(max(x, lo), hi)))
    return float(x)


def _parzen(points: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Adaptive-bandwidth Parzen mixture on [0,1] plus a flat-ish prior component.

    Bandwidths follow hyperopt's adaptive scheme: each point's sigma is the
    larger gap to its sorted neighbors, clipped to [1/min(100, 1+n), 1].
    The prior is a wide Gaussian at 0.5 approximating the uniform prior, which
    keeps exploration alive (optuna's ``consider_prior=true``).
    """
    n = len(points)
    mus = np.concatenate([points, [0.5]])
    if n == 0:
        return mus, np.asarray([1.0])
    order = np.argsort(points)
    srt = points[order]
    ext = np.concatenate([[0.0], srt, [1.0]])
    gaps = np.maximum(ext[1:-1] - ext[:-2], ext[2:] - ext[1:-1])
    sigmas = np.empty(n)
    sigmas[order] = np.clip(gaps, 1.0 / min(100.0, 1.0 + n), 1.0)
    return mus, np.concatenate([sigmas, [1.0]])


def _log_mixture_pdf(x: np.ndarray, mus: np.ndarray, sigmas: np.ndarray) -> np.ndarray:
    """log pdf of an equal-weight Gaussian mixture, evaluated at x (vectorized)."""
    z = (x[:, None] - mus[None, :]) / sigmas[None, :]
    log_comp = -0.5 * z**2 - np.log(sigmas[None, :] * math.sqrt(2 * math.pi))
    m = log_comp.max(axis=1, keepdims=True)
    return (m[:, 0] + np.log(np.exp(log_comp - m).mean(axis=1)))


class TPESampler:
    """Univariate Tree-structured Parzen Estimator (Bergstra et al. 2011).

    Matches the reference's ``optuna.samplers.TPESampler`` behavior surface
    (reference configs/hparams_search/perceiver_optuna.yaml:32-43):
    ``n_startup_trials`` random trials, then per-parameter l(x)/g(x)
    optimization over ``n_ei_candidates`` candidates drawn from l.
    """

    def __init__(
        self,
        seed: int = 0,
        n_startup_trials: int = 5,
        n_ei_candidates: int = 24,
        gamma: float = 0.25,
    ):
        self.rng = np.random.default_rng(seed)
        self.n_startup_trials = n_startup_trials
        self.n_ei_candidates = n_ei_candidates
        self.gamma = gamma

    def suggest(
        self,
        space: Dict[str, Any],
        history: Sequence[Tuple[Dict[str, Any], Optional[float]]],
    ) -> Dict[str, Any]:
        """Propose the next trial's params given [(params, value)] history
        (values already sign-adjusted so lower is better; None = failed)."""
        ok = [(p, v) for p, v in history if v is not None and math.isfinite(v)]
        if len(ok) < self.n_startup_trials:
            return sample_params(space, self.rng)
        ok.sort(key=lambda pv: pv[1])
        n_good = max(1, int(math.ceil(self.gamma * len(ok))))
        good = [p for p, _ in ok[:n_good]]
        bad = [p for p, _ in ok[n_good:]] or good  # degenerate: all good

        out: Dict[str, Any] = {}
        for key, spec in space.items():
            kind = spec.get("type", "uniform")
            if kind == "categorical":
                out[key] = self._suggest_categorical(spec, key, good, bad)
            else:
                out[key] = self._suggest_numeric(spec, key, good, bad)
        return out

    def _suggest_numeric(self, spec, key, good, bad):
        g_pts = np.asarray([_to_unit(p[key], spec) for p in good if key in p])
        b_pts = np.asarray([_to_unit(p[key], spec) for p in bad if key in p])
        mus_l, sig_l = _parzen(g_pts)
        mus_g, sig_g = _parzen(b_pts)
        # Sample candidates from l: pick a component, draw, clip into [0,1].
        comp = self.rng.integers(len(mus_l), size=self.n_ei_candidates)
        cand = np.clip(
            self.rng.normal(mus_l[comp], sig_l[comp]), 0.0, 1.0
        )
        score = _log_mixture_pdf(cand, mus_l, sig_l) - _log_mixture_pdf(
            cand, mus_g, sig_g
        )
        return _from_unit(float(cand[int(np.argmax(score))]), spec)

    def _suggest_categorical(self, spec, key, good, bad):
        choices = list(spec["choices"])
        idx = {repr(c): i for i, c in enumerate(choices)}

        def probs(group):
            counts = np.ones(len(choices))  # +1 prior smoothing
            for p in group:
                if key in p and repr(p[key]) in idx:
                    counts[idx[repr(p[key])]] += 1
            return counts / counts.sum()

        p_l, p_g = probs(good), probs(bad)
        cand = self.rng.choice(len(choices), size=self.n_ei_candidates, p=p_l)
        score = np.log(p_l[cand]) - np.log(p_g[cand])
        return choices[int(cand[int(np.argmax(score))])]


def sweep(config: Dict[str, Any]) -> float:
    from satflow_tpu_torch.experiments.train import train

    search = config.get("hparams_search", {})
    space: Dict[str, Any] = search.get("search_space", {})
    n_trials: int = int(search.get("n_trials", 10))
    direction: str = search.get("direction", "minimize")
    metric_name: str = search.get(
        "optimized_metric", config.get("optimized_metric", "val/loss")
    )
    sign = 1.0 if direction == "minimize" else -1.0
    seed = int(config.get("seed", 0) or 0)
    rng = np.random.default_rng(seed)
    sampler_name = str(search.get("sampler", "tpe")).lower()
    sampler = (
        TPESampler(
            seed=seed,
            n_startup_trials=int(search.get("n_startup_trials", 5)),
            n_ei_candidates=int(search.get("n_ei_candidates", 24)),
            gamma=float(search.get("gamma", 0.25)),
        )
        if sampler_name == "tpe"
        else None
    )

    results = []
    history: List[Any] = []  # [(params, sign*value)] for the TPE sampler
    best_value = math.inf
    best_params: Dict[str, Any] = {}
    for trial in range(n_trials):
        if sampler is not None:
            params = sampler.suggest(space, history)
        else:
            params = sample_params(space, rng)
        trial_cfg = copy.deepcopy(config)
        trial_cfg["optimized_metric"] = metric_name
        for key, value in params.items():
            _set_dotted(trial_cfg, key, value)
        log.info("Trial %d/%d: %s", trial + 1, n_trials, params)
        try:
            value = train(trial_cfg)
        except Exception as e:  # noqa: BLE001 - a failed trial shouldn't kill the sweep
            log.warning("Trial %d failed: %s", trial + 1, e, exc_info=True)
            value = None
        score = math.inf if value is None else sign * value
        history.append((params, None if value is None else sign * value))
        results.append({"trial": trial, "params": params, "value": value})
        if score < best_value:
            best_value = score
            best_params = params

    out_dir = config.get("sweep_dir", "logs/sweeps")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "results.json"), "w") as f:
        json.dump(
            {"best_value": sign * best_value, "best_params": best_params,
             "trials": results},
            f, indent=2, default=str,
        )
    log.info("Sweep done. Best %s=%s with %s", metric_name, sign * best_value, best_params)
    return sign * best_value
