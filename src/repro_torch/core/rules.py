"""The 81-item fuzzy rule base (paper Table 2).

The paper publishes 9 of the 81 rows (rules 1-3, 52-54, 79-81) and states
the rest were tuned empirically.  We reconstruct the full table from two
principles that reproduce *all nine published anchors exactly*:

1. **Additive contribution** — when the vehicle can upload (TA or CC not
   both at their worst level), the consequent level is the sum of the four
   linguistic indices (each in {0,1,2}), giving L0..L8:
       rule 1  (Suff,High,Strong,Greater)  2+2+2+2 = L8  ✓
       rule 2  (Avg, High,Strong,Greater)  1+2+2+2 = L7  ✓
       rule 3  (Short,High,Strong,Greater) 0+2+2+2 = L6  ✓
2. **Upload bottleneck** — when TA=Poor AND CC=Weak the model likely
   cannot be uploaded before the deadline, so only dataset quality
   matters, multiplicatively: level = SQ_idx * LF_idx:
       rule 52 (Suff,Poor,Weak,Middle)  2*1 = L2  ✓
       rule 53 (Avg, Poor,Weak,Middle)  1*1 = L1  ✓
       rule 54 (Short,Poor,Weak,Middle) 0*1 = L0  ✓
       rules 79-81 (*,Poor,Weak,Smaller)  *  = L0  ✓✓✓

The table is monotone: raising any input level never lowers the output
level (property-tested in tests/test_fuzzy.py).

Variable order and linguistics follow the paper:
  SQ (sample quantity):          shortage / average / sufficient
  TA (throughput available):     poor / middle / good
  CC (computational capability): weak / middle / strong
  LF (loss function):            smaller / middle / greater
Index 0 is always the worst level, 2 the best ("greater loss" = more
dataset diversity = better, per §5.3).
"""
from __future__ import annotations

import itertools
from typing import Tuple

import numpy as np

NUM_VARS = 4
NUM_LEVELS = 3
NUM_OUT = 9
VAR_NAMES = ("SQ", "TA", "CC", "LF")
LINGUISTICS = {
    "SQ": ("shortage", "average", "sufficient"),
    "TA": ("poor", "middle", "good"),
    "CC": ("weak", "middle", "strong"),
    "LF": ("smaller", "middle", "greater"),
}


def consequent(sq: int, ta: int, cc: int, lf: int) -> int:
    """Output level L0..L8 for one antecedent combination."""
    if ta == 0 and cc == 0:               # upload bottleneck
        return sq * lf
    return sq + ta + cc + lf              # additive contribution


def build_rule_table() -> Tuple[np.ndarray, np.ndarray]:
    """Returns (rule_table (81,4) int32, rule_levels (81,) int32).

    Enumeration order matches the paper's Table 2 exactly: within each
    consecutive triplet SQ descends (sufficient, average, shortage), and
    across triplets CC, then TA, then LF descend — this places the paper's
    published rows (1-3, 52-54, 79-81) at the same indices with the same
    antecedents:  rule r-1 = (lf, ta, cc, sq) =
    (2 - (r-1)//27, 2 - ((r-1)%27)//9, 2 - ((r-1)%9)//3, 2 - (r-1)%3).
    """
    rows, levels = [], []
    for lf, ta, cc, sq in itertools.product(range(2, -1, -1), repeat=4):
        rows.append((sq, ta, cc, lf))
        levels.append(consequent(sq, ta, cc, lf))
    return (np.asarray(rows, np.int32), np.asarray(levels, np.int32))


# Published anchor rows (1-indexed rule number -> expected level).
PAPER_ANCHORS = {
    1: 8, 2: 7, 3: 6,          # Suff/Avg/Short, High, Strong, Greater
    52: 2, 53: 1, 54: 0,       # Suff/Avg/Short, Poor, Weak, Middle
    79: 0, 80: 0, 81: 0,       # Suff/Avg/Short, Poor, Weak, Smaller
}


def verify_anchors() -> bool:
    table, levels = build_rule_table()
    # paper enumerates (SQ outer desc, then TA desc, CC desc, LF desc)
    for rule_no, want in PAPER_ANCHORS.items():
        if int(levels[rule_no - 1]) != want:
            return False
    return True
