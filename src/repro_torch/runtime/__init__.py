from .elastic import elastic_restore, reshard_tree
from .fault_tolerance import (FailureInjector, StepWatchdog, TrainLoopRunner,
                              load_into)
