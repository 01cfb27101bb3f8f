from .logger import get_logger, set_verbose
from .progress import ProgressReporter
from .profiler import Profiler, kernel_timer
