"""The compiled batch tier's two layouts kept in step, without a card.

``csrc/batchsim_advance.cu`` reads the packed buffer through its ``Header``
and ``Table`` enums and carves each lane's shared memory with
``shared_words``; ``kernels/batchsim_advance.py`` packs the buffer from
``HEADER`` and ``TABLES`` and sizes the launch with ``shared_bytes``. These
cases parse the source and hold the two sides to each other, and the shared
memory of a block to a count by hand.
"""
import re
from pathlib import Path

import pytest

from repro_torch.kernels import batchsim_advance as kb

CU = (Path(kb.__file__).resolve().parent / "csrc" / "batchsim_advance.cu").read_text()
# dynamic shared memory a block may take on an H100 (227 KB, opted in)
H100_SHARED_LIMIT = 232_448


def _enum(name):
    body = re.search(r"enum %s \{([^}]*)\}" % name, CU).group(1)
    return [w.strip() for w in body.split(",") if w.strip()]


def test_header_enum_lists_header_in_order():
    names = _enum("Header")
    assert names[-1] == "H_COUNT"
    assert [n[2:].lower() for n in names[:-1]] == [h.lower() for h in kb.HEADER]


def test_table_enum_lists_tables_in_order():
    names = _enum("Table")
    assert names[-1] == "T_COUNT"
    assert [n[2:].lower() for n in names[:-1]] == [t[0] for t in kb.TABLES]


def test_lanes_per_block_in_step():
    cu = int(re.search(r"constexpr int LANES_PER_BLOCK = (\d+);", CU).group(1))
    assert cu == kb.LANES_PER_BLOCK


@pytest.mark.parametrize("G,P,NP", [(1, 3, 2), (2, 3, 4), (3, 3, 6), (4, 5, 9), (40, 3, 33)])
def test_shared_words_formula_in_step(G, P, NP):
    """The ``.cu``'s ``shared_words`` expression, evaluated, equals the
    wrapper's at the same sizes."""
    expr = re.search(r"i64 shared_words\(i64 G, i64 P, i64 NP\) \{\s*const i64 C = G \+ P \+ 1;"
                     r"\s*return ([^;]+);", CU).group(1)
    assert eval(expr, {}, dict(G=G, P=P, NP=NP, C=G + P + 1)) == kb.shared_words(G, P, NP)


def test_shared_bytes_hand_count_at_the_sweep_shape():
    """G 3, P 3, NP 6 (sweep scenario 1's widest batch): per lane the
    frontier's times and seqs 7 + 7 words, busy 3, src_rid 3, idle, end_g and
    end_rr 3 each, the delivery ring 4, the FIFO heads and tails 18 each: 69
    words, 552 B; two lanes a block: 1,104 B, under half a percent of the
    H100's 232,448 and under the 48 KB a launch takes without opting in."""
    per_lane = 8 * (7 + 7 + 3 + 3 + 3 + 3 + 3 + 4 + 18 + 18)
    assert per_lane == 552
    sizes = dict(G=3, P=3, NP=6)
    assert kb.shared_bytes(sizes) == kb.LANES_PER_BLOCK * per_lane == 1104
    assert kb.shared_bytes(sizes) < 0.005 * H100_SHARED_LIMIT
    assert kb.shared_bytes(sizes) <= 48 * 1024


def test_shared_bytes_grow_with_the_fifo_classes_only_linearly():
    """A block passes the card's limit only near 2,400 priority classes at
    P 3: 16 bytes a word for two lanes, 6 words a class."""
    base = kb.shared_bytes(dict(G=3, P=3, NP=6))
    assert kb.shared_bytes(dict(G=3, P=3, NP=7)) - base == 16 * 6
    assert kb.shared_bytes(dict(G=3, P=3, NP=2400)) < H100_SHARED_LIMIT
    assert kb.shared_bytes(dict(G=3, P=3, NP=2500)) > H100_SHARED_LIMIT
