"""Online scoring on the card (port of ``transmogrifai_tpu/serving``).

``engine.ScoringEngine`` coalesces concurrent requests into padded batches
through the model's ``ScoreProgram``; ``server`` exposes it over stdlib HTTP
with health, Prometheus metrics, admission control, hot model reload and
SIGTERM draining; ``wire`` is the packed columnar format and ``overload``
the admission, breaker and health policy.  Both load and score on CUDA
unless the caller passes ``device="cpu"``.

Not ported yet: the multi-process pool (``pool.py``) and the multi-tenant
registry (``tenants.py``).
"""

from . import overload, wire  # noqa: F401
from .engine import (DeadlineExceeded, EngineClosed,  # noqa: F401
                     OverloadedError, ScoringEngine)
from .overload import (BROWNOUT, DEGRADED, DRAINING,  # noqa: F401
                       HEALTH_STATES, SERVING, HealthStateMachine,
                       OverloadConfig, OverloadController)
from .server import ScoringHTTPServer, serve_main, start_server  # noqa: F401
