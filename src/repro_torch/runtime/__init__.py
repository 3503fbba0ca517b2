from .serving import Request, ServingEngine
from .steps import make_decode_step, make_prefill_step

__all__ = ["Request", "ServingEngine", "make_prefill_step",
           "make_decode_step"]
