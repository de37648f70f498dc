"""Observability of the chunk loop, ported from the JAX package's
``obs`` layer: the metrics registry (:mod:`.metrics`, names in
:mod:`.names`), spans and the device trace (:mod:`.trace`), device memory
(:mod:`.memory`), roofline accounting (:mod:`.roofline`), the canary
(:mod:`.canary`), health and the HTTP surface (:mod:`.health`,
:mod:`.server`), lineage and push (:mod:`.lineage`, :mod:`.push`), the
ETA's throughput (:mod:`.capacity`) and the survey report
(:mod:`.report`)."""
