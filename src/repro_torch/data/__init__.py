from repro_torch.data.corpus import load_text_dir, synthetic_wikipedia
from repro_torch.data.pipeline import (Loader, PackedDataset, build_dataset,
                                       pack_documents)
from repro_torch.data.tokenizer import Tokenizer

__all__ = ["Loader", "PackedDataset", "Tokenizer", "build_dataset",
           "load_text_dir", "pack_documents", "synthetic_wikipedia"]
