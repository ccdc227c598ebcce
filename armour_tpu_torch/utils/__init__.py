"""See the matching subpackage of armour_tpu for the reference."""

from armour_tpu_torch.utils.timers import PhaseTimer
from armour_tpu_torch.utils.summary import summarize_episodes, format_summary

__all__ = ["PhaseTimer", "summarize_episodes", "format_summary"]
