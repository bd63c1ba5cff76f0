"""Corpus preprocessing: the sharded map-with-retry engine
(``shard_engine.py``), G2P (``phonemize.py``), diacritization
(``diacritize.py``) and the stages of ``pipeline.py`` (clean, phonemize,
tokenize, pack, diacritize, all). The exports are
``pl_bert_tpu/preprocess/__init__.py``'s."""
from pl_bert_tpu_torch.preprocess.shard_engine import process_dataset  # noqa: F401
from pl_bert_tpu_torch.preprocess.phonemize import (  # noqa: F401
    EspeakBackend,
    IdentityG2P,
    get_g2p_backend,
    phonemize_text,
    separate_text_into_segments,
)
from pl_bert_tpu_torch.preprocess.pipeline import (  # noqa: F401
    main_clean,
    main_diacritize,
    main_phonemize,
    standardize_text,
)
