"""Horizontally scaled survey orchestration: the port of the JAX
package's fleet.

A coordinator/worker fleet that shards a survey (many filterbank files x
chunk ranges) into leased work units over a JSON wire protocol:

* :mod:`.protocol` — the wire messages, the search-config whitelist a
  lease may carry, and the urllib JSON client the worker uses;
* :mod:`.coordinator` — :class:`~.coordinator.FleetCoordinator`, a host
  process: unit sharding via
  :func:`~..pipeline.search_pipeline.plan_survey`, lease TTLs,
  health-probed work-stealing, each file's resume ledger as the shared
  completion record;
* :mod:`.worker` — :class:`~.worker.FleetWorker`: runs each leased unit
  through ``search_by_chunks`` (or ``periodicity_search``) on its own
  device, reports completions with its metrics snapshot and health
  verdict, drains on SIGTERM/SIGINT;
* :mod:`.journal` — :class:`~.journal.FleetJournal`, the coordinator's
  write-ahead ``fleet_journal.jsonl``, replayed by
  :meth:`~.coordinator.FleetCoordinator.recover`; the units' lease
  epochs fence a partitioned worker's late writes.

``python -m pulsarutils_tpu_torch.cli.fleet_main coordinator|worker``
runs either role.  The journal, the ledgers and the fence map are the
JAX package's files: one package's coordinator recovers the other's.
"""

from .coordinator import FleetCoordinator
from .worker import FleetWorker

__all__ = ["FleetCoordinator", "FleetWorker"]
