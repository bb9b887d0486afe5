"""User-facing object API, mirroring the reference R surface.

`Insider` is the analog of the S3 "insider" object (R/insider.R:18-67):
it owns the data, the seeded train/test element split, the confounder matrix
with the interaction pseudo-confounder inserted, and fit parameters.
`.tune()` and `.fit()` mirror R/insider.R:81-176 and :190-216.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np

from insider_tpu.config import FitConfig, ShardingConfig
from insider_tpu.data.splitter import ratio_splitter
from insider_tpu.train import als


def build_interaction_codes(
    confounder: np.ndarray, interaction_idx: Sequence[int]
) -> np.ndarray:
    """Level codes for the interaction of the selected confounder columns.

    Reference: unique rows of confounder[:, idx] enumerated in
    first-appearance order of `unique()`, each row assigned its combination's
    index (R/insider.R:34-39).  Codes are 1-based like the reference.
    """
    sub = np.asarray(confounder)[:, list(interaction_idx)]
    # np.unique sorts; R unique() keeps first-appearance order. Either yields
    # a valid enumeration of combinations; we keep first-appearance for parity
    # with the reference's level ordering.
    _, first_idx, inv = np.unique(
        sub, axis=0, return_index=True, return_inverse=True
    )
    order = np.argsort(np.argsort(first_idx))
    return (order[inv] + 1).astype(np.int64)


class Insider:
    """INSIDER model object.

    Args mirror R/insider.R:18 (0-based `interaction_idx`, unlike R's
    1-based).  The interaction pseudo-confounder is inserted as column 2 of
    the confounder matrix — the code's behavior, not the README's claim
    (R/insider.R:40 vs README.md:127; SURVEY.md §7 hard-part 6).
    """

    def __init__(
        self,
        data: np.ndarray,
        confounder: np.ndarray,
        ctns_confounder: Optional[np.ndarray] = None,
        interaction_idx: Optional[Sequence[int]] = None,
        split_ratio: float = 0.1,
        global_tol: float = 1e-9,
        sub_tol: float = 1e-5,
        tuning_iter: int = 30,
        max_iter: int = 50000,
        rm_na_col: bool = True,
        split_seed: int = 123,
        seed: int = 0,
        sharding: Optional[ShardingConfig] = None,
    ):
        data = np.asarray(data, np.float64)
        confounder = np.asarray(confounder)
        if confounder.ndim == 1:
            confounder = confounder[:, None]
        if confounder.shape[0] != data.shape[0]:
            raise ValueError("confounder rows must match data rows")

        split = ratio_splitter(data, ratio=split_ratio, rm_na_col=rm_na_col,
                               seed=split_seed)
        self.split = split
        self.data = split.data  # NaNs zeroed, filtered consistently

        if interaction_idx is not None:
            idx = list(interaction_idx)
            if len(idx) < 2:
                raise ValueError(
                    "interaction_idx must select at least 2 confounders "
                    "(R/insider.R:45)"
                )
            if max(idx) >= confounder.shape[1]:
                raise ValueError(
                    "interaction_idx out of range of confounder (R/insider.R:31)"
                )
            inter = build_interaction_codes(confounder, idx)
            # Insert as column 2 (R/insider.R:40).
            self.confounder = np.column_stack(
                [confounder[:, 0], inter, confounder[:, 1:]]
            )
        else:
            self.confounder = confounder.copy()

        if ctns_confounder is not None:
            ctns = np.asarray(ctns_confounder, np.float64)
            if ctns.ndim == 1:
                ctns = ctns[:, None]
            self.ctns_confounder = ctns
            self.inc_continuous = True
        else:
            self.ctns_confounder = None
            self.inc_continuous = False

        self.train_indicator = split.train_indicator
        self.test_indicator = split.test_indicator
        self.na_indicator = split.na_indicator
        self.params = dict(global_tol=global_tol, sub_tol=sub_tol,
                           tuning_iter=tuning_iter, max_iter=max_iter)
        self.seed = seed
        self.sharding = sharding

        # populated by fit()
        self.cfd_matrices: Optional[List[np.ndarray]] = None
        self.column_factor: Optional[np.ndarray] = None
        self.test_rmse: Optional[float] = None
        self.fit_result: Optional[als.OptimizeResult] = None

    # ------------------------------------------------------------------ #

    def _config(self, latent_dimension, lambda_, alpha, max_iter, masked,
                **overrides):
        return FitConfig(
            latent_dim=int(latent_dimension),
            lambda1=float(lambda_),
            lambda2=float(lambda_),  # R passes lambda for both (R/insider.R:209)
            alpha=float(alpha),
            masked=masked,
            global_tol=self.params["global_tol"],
            sub_tol=self.params["sub_tol"],
            max_iter=int(max_iter),
            seed=self.seed,
            **overrides,
        )

    def tune(self, latent_dimension, lambda_=0.1, alpha=0.0, out_dir="."):
        """Two-stage rank / (lambda, alpha) search (R/insider.R:81-176)."""
        from insider_tpu.tune.grid import tune as _tune

        return _tune(self, latent_dimension, lambda_, alpha, out_dir=out_dir)

    def fit(self, latent_dimension, lambda_, alpha, partition=0,
            verbose=True, log_jsonl=None, col_solver="auto", use_pallas=None,
            checkpoint_path=None, resume=False, mask_dtype=None,
            precompute=True, max_iter=None):
        """Final fit (R/insider.R:190-216).

        partition=1: only the train+test (observed) elements drive updates,
        NA cells form the held-out "test" mask.  partition=0: dense
        whole-matrix fast path.  (R/insider.R:207-209 — train+test is passed
        as the train mask, na as the test mask, partition as `tuning`.)

        The performance/robustness knobs are forwarded to FitConfig /
        als.build_problem / als.optimize:
          col_solver: "auto" | "fss" | "cd" (FitConfig.col_solver).
          use_pallas: the Triton column-solve kernel on/off; None = auto
            (on for the 'gpu' backend, off for 'cpu'; True off the GPU
            raises).
          checkpoint_path (+resume): boundary snapshots / deterministic resume.
          mask_dtype: e.g. jnp.uint8 for the memory-lean indicator storage.
          precompute: build the per-problem row-update constants (False =
            memory-lean mode for near-HBM-limit shapes).
          max_iter: override the object's default iteration budget.
        """
        cfg = self._config(latent_dimension, lambda_, alpha,
                           self.params["max_iter"] if max_iter is None
                           else max_iter,
                           masked=bool(partition),
                           col_solver=col_solver, use_pallas=use_pallas)
        indicator = self.train_indicator + self.test_indicator
        problem = als.build_problem(
            self.data, self.confounder, indicator, self.na_indicator,
            self.ctns_confounder, masked=bool(partition),
            sharding=self.sharding, mask_dtype=mask_dtype,
            precompute=precompute,
        )
        result = als.optimize(problem, cfg, verbose=verbose,
                              log_jsonl=log_jsonl,
                              checkpoint_path=checkpoint_path, resume=resume)
        self.cfd_matrices = result.row_matrices
        if result.ctns_factor is not None:
            self.cfd_matrices = self.cfd_matrices + [result.ctns_factor]
        self.column_factor = result.column_factor
        self.test_rmse = result.test_rmse
        self.fit_result = result
        return self

    def tuning_problem(self) -> als.Problem:
        """The masked problem used by tune(): train vs held-out test."""
        return als.build_problem(
            self.data, self.confounder, self.train_indicator,
            self.test_indicator, self.ctns_confounder, masked=True,
            sharding=self.sharding,
        )


FitResult = als.OptimizeResult
