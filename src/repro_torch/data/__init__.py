"""Data plane: deterministic token datasets + MDTP multi-source pipeline."""

from .pipeline import (MultiSourcePipeline, TokenDatasetSpec, synthetic_tokens,
                       write_token_dataset)

__all__ = ["MultiSourcePipeline", "TokenDatasetSpec", "synthetic_tokens",
           "write_token_dataset"]
