from .logger import g_logger, Logger, FatalError
from .timer import g_timer, Timer
from . import namelist

__all__ = ["g_logger", "Logger", "FatalError", "g_timer", "Timer", "namelist"]
