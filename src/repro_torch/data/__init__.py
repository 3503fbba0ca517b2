from .pipeline import SyntheticTokenStream, batch_specs

__all__ = ["SyntheticTokenStream", "batch_specs"]
