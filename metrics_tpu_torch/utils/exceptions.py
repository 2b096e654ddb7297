"""User-facing exceptions (counterpart of ``metrics_tpu/utils/exceptions.py``)."""


class MetricsUserError(Exception):
    """Error raised when a misuse of the metric state machine is detected."""


class MetricsUserWarning(UserWarning):
    """Warning raised for recoverable metric misuse."""
