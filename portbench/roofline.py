"""The yardstick's peaks and the least work of each measured call.

Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet; rates at the full
700 W power limit): 67 TFLOP/s of float32 outside the tensor cores, the
special-function units at 16 results a clock an SM over 132 SMs at the
1.98 GHz boost clock, and 3.35 TB/s of HBM3.  A call's least time is the
largest of its three bounds: its float32 operations at the FLOP rate,
its transcendental results at the SFU rate, its bytes at the memory
rate.  Every count comes from the shapes and the inputs, never from the
program: each input byte read once, each output byte written once, and
the work that the comparison deciding ``correct`` forces on any program
that passes it.
"""
from __future__ import annotations

import dataclasses

PEAK_F32_FLOPS = 67e12
SMS = 132
BOOST_CLOCK_HZ = 1.98e9
SFU_RESULTS_PER_CLOCK_PER_SM = 16
PEAK_SFU_PER_S = SFU_RESULTS_PER_CLOCK_PER_SM * SMS * BOOST_CLOCK_HZ
PEAK_BYTES_PER_S = 3.35e12


@dataclasses.dataclass(frozen=True)
class Work:
    """What a call has to do: float32 operations, transcendental results
    and bytes moved."""
    flops: float = 0.0
    sfu: float = 0.0
    nbytes: float = 0.0

    def __add__(self, other: "Work") -> "Work":
        return Work(self.flops + other.flops, self.sfu + other.sfu,
                    self.nbytes + other.nbytes)


def least_seconds(w: Work) -> float:
    """The least time the card can take for ``w``."""
    return max(w.flops / PEAK_F32_FLOPS, w.sfu / PEAK_SFU_PER_S,
               w.nbytes / PEAK_BYTES_PER_S)


def bound_by(w: Work) -> str:
    """Which of the three bounds sets :func:`least_seconds`."""
    t = {"flops": w.flops / PEAK_F32_FLOPS, "sfu": w.sfu / PEAK_SFU_PER_S,
         "bytes": w.nbytes / PEAK_BYTES_PER_S}
    return max(t, key=t.get)


# -- LDA ----------------------------------------------------------------------

#: per active token and topic, the dense Gumbel-max conditional: the two
#: logs of the Gumbel draw −log(−log u).  log(γ + B[v, k]) and
#: log(α + D[d, k]) are logs of whole numbers: a program reads them from
#: a table (the port's kernel does), so they count as the table's bytes,
#: not as SFU work
LDA_LOGS_PER_TOPIC = 2
#: per active token: log(V·γ + s̃[k]) anew at the two topics whose total
#: its move changed (a worker keeps the K of them)
LDA_LOGS_PER_TOKEN = 2
#: per active token and topic: the three sums of the logits and the
#: noise, and the compare of the argmax
LDA_FLOPS_PER_TOPIC = 4
#: per active token: its word, document and topic read, its topic written
LDA_TOKEN_BYTES = 16


def lda_round(tokens: int, word_rows: int, doc_rows: int,
              num_topics: int, table_entries: int = 0) -> Work:
    """One Gibbs round that samples ``tokens`` tokens, whose words cover
    ``word_rows`` distinct rows of B and whose documents ``doc_rows``
    distinct rows of D: the dense conditional over all K topics of every
    token (the comparison holds the sampler to the Gumbel-max draw of
    every topic), each distinct count row read once, the token's ids read
    and its topic written, and a float32 table of ``table_entries`` logs
    of counts read once."""
    tk = float(tokens) * num_topics
    return Work(flops=LDA_FLOPS_PER_TOPIC * tk,
                sfu=LDA_LOGS_PER_TOPIC * tk
                + LDA_LOGS_PER_TOKEN * float(tokens),
                nbytes=4.0 * num_topics * (word_rows + doc_rows)
                + LDA_TOKEN_BYTES * float(tokens) + 4.0 * table_entries)


# -- MF -----------------------------------------------------------------------

#: per observed rating and round: two multiply-adds into the partial sums
#: (Σ w r and Σ m w², or the W-phase's pair) and one into the residual
MF_FLOPS_PER_RATING = 6
#: per observed rating and round: its residual read and written, and its
#: column (or row) index read
MF_RATING_BYTES = 12


def mf_round(observed: int, users: int, items: int) -> Work:
    """One rank-wise coordinate round over ``observed`` ratings of a
    ``users`` × ``items`` matrix: every observed residual read, updated
    and written once, the rank's column of W and row of H read and one of
    them written.  Only the observed entries count: the dense layout's
    other (N·M − |Ω|) entries are the program's choice, not the task's
    work."""
    return Work(flops=MF_FLOPS_PER_RATING * float(observed),
                nbytes=MF_RATING_BYTES * float(observed)
                + 8.0 * (users + items))
