"""The job service of the JAX package (``SurveyService``): not ported.

It feeds same-geometry jobs submitted over HTTP into the beam batcher;
it belongs to the service layers, ROADMAP.md queue A, A10.
"""

_NOT_PORTED = "queue A, A10 (service layers)"

raise ImportError("pulsarutils_tpu_torch.beams.service (SurveyService) is "
                  f"not ported yet: ROADMAP.md {_NOT_PORTED}")
