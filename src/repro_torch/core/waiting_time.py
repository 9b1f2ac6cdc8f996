"""Queue waiting-time estimation (QLM-style; paper §5.3, Eq. 1).

W_q = sum_{i<q} O_i / Theta, with unknown output lengths O_i modelled as a
Normal(mu_o, sigma_o) fitted online from completed requests. By the CLT the
sum over q-1 requests ahead is Normal(q*mu, sqrt(q)*sigma) for any
underlying output distribution, so estimates sharpen as the queue grows
(paper Fig. 14: R^2 -> 0.99 at ~2000 queued requests).
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field


@dataclass
class OutputLengthModel:
    """Online mean/std of completed-request output lengths.

    ``observe`` runs once per completion on the event core's hot path, so
    it only accumulates the moment sums; ``mu``/``sigma`` refresh lazily
    on read (control ticks). The values are bit-identical to eager
    recomputation — both reduce to the same ``_sum/_n`` arithmetic at the
    same observation count."""
    _n: int = 0
    _sum: float = 0.0
    _sumsq: float = 0.0
    _mu: float = 256.0              # prior before any observations
    _sigma: float = 128.0
    _stale: bool = False

    def observe(self, output_len: int) -> None:
        self._n += 1
        self._sum += output_len
        self._sumsq += output_len * output_len
        self._stale = True

    def _refresh(self) -> None:
        self._stale = False
        if self._n >= 2:
            self._mu = self._sum / self._n
            var = max(self._sumsq / self._n - self._mu ** 2, 1.0)
            self._sigma = math.sqrt(var)

    @property
    def mu(self) -> float:
        if self._stale:
            self._refresh()
        return self._mu

    @mu.setter
    def mu(self, value: float) -> None:
        self._mu = value

    @property
    def sigma(self) -> float:
        if self._stale:
            self._refresh()
        return self._sigma

    @sigma.setter
    def sigma(self, value: float) -> None:
        self._sigma = value

    @property
    def n_observed(self) -> int:
        return self._n


@dataclass
class WaitingTimeEstimator:
    """Estimates queue waiting time given per-instance token throughput.

    ``token_throughput`` is Theta in Eq. 1 — assumed constant through the
    generation due to the statistical averaging of continuous batching.
    """
    output_model: OutputLengthModel = field(default_factory=OutputLengthModel)
    quantile_z: float = 0.0         # >0 for conservative upper estimates

    def expected_tokens(self, n_requests: int) -> float:
        mean = n_requests * self.output_model.mu
        if self.quantile_z > 0 and n_requests > 0:
            mean += self.quantile_z * math.sqrt(n_requests) * self.output_model.sigma
        return mean

    def waiting_time(self, n_requests_ahead: int, token_throughput: float,
                     n_instances: int = 1) -> float:
        """Eq. 1: W_q = sum O_i / Theta across ``n_instances`` instances."""
        if n_requests_ahead <= 0:
            return 0.0
        theta = max(token_throughput * max(n_instances, 1), 1e-9)
        return self.expected_tokens(n_requests_ahead) / theta
