from repro_torch.data.corpus import Corpus  # noqa: F401
from repro_torch.data.corpus_store import (  # noqa: F401
    CorpusStore,
    build_layout_from_store,
    carry_assignments,
    remap_canonical,
    update_layout,
)
