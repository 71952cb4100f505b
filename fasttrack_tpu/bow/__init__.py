"""Bag-of-binary-words place recognition (the reference's Thirdparty/DBoW2).

Re-design (SURVEY.md 2.3): DBoW2's k-ary vocabulary tree exists to make
CPU quantization O(k log W); on an accelerator, quantization against the
FULL word list is one int8 matmul, so the vocabulary is a flat array of word
centroids + idf weights. The inverted index and candidate grouping stay on
host (tiny dict work), mirroring the reference's KeyFrameDatabase.
"""

from fasttrack_tpu.bow.vocabulary import (  # noqa: F401
    Vocabulary,
    train_vocabulary,
    l1_score,
)
from fasttrack_tpu.bow.database import KeyFrameDatabase  # noqa: F401
