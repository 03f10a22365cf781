"""Path and constant configuration — the reference's ``conf`` layer.

Reference: ``src/liuyang/nlp/lda/conf/PathConfig.java`` (:~5–10) and
``conf/ConstantConfig.java`` (:~5) — compile-time constants naming the corpus
directory, the results directory, and the tab-separated parameter file
(SURVEY.md §2.1 #6–#7).  Here they are module constants consumed as *defaults*
by the CLI (``cli.py``), overridable per run — the conscious redesign of the
reference's hard-coded paths (SURVEY.md §5 "Config / flag system" row).
"""

from __future__ import annotations

# PathConfig.ldaDocsPath
LDA_DOCS_PATH = "data/LdaOriginalDocs/"
# PathConfig.LdaResultsPath
LDA_RESULTS_PATH = "data/LdaResults/"
# ConstantConfig.LDAPARAMETERFILE
LDA_PARAMETER_FILE = "data/LdaParameterFile/LdaParameters.txt"
