"""User-facing exceptions (counterpart of ``metrics_tpu/utils/exceptions.py``)."""


class MetricsUserError(Exception):
    """Error raised when a misuse of the metric state machine is detected."""


class MetricsUserWarning(UserWarning):
    """Warning raised for recoverable metric misuse."""


class Uncapturable(Exception):
    """A step that a CUDA graph cannot hold: it reads a value back to the
    host, or makes a tensor whose shape depends on values. The compiled
    engines (``core/engine.py``) revert such a metric to eager."""
