"""Corpus ingestion and preprocessing (reference: ``main/Documents.java``,
``com/FileUtil.java``, ``com/Stopwords.java``)."""

from ldagibbssampling_tpu_torch.corpus.documents import Document, Documents
from ldagibbssampling_tpu_torch.corpus.flat import FlatCorpus
from ldagibbssampling_tpu_torch.corpus.stopwords import STOPWORDS, is_stopword

__all__ = ["Document", "Documents", "FlatCorpus", "STOPWORDS", "is_stopword"]
