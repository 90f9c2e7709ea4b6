"""Stage timers (``openpano_tpu.utils``'s public names)."""

from .timer import guarded_timer, report, reset, total_timer, totals

__all__ = ["guarded_timer", "total_timer", "totals", "reset", "report"]
