"""genometools_tpu — a JAX sequence-indexing and matching engine.

A from-scratch JAX/XLA framework with the capabilities of GenomeTools
(enhanced suffix arrays, k-mer counting, maximal repeats,
seed-and-extend alignment, string-graph assembly, GFF3 annotation
processing), designed data-parallel-first for accelerator device
meshes; it runs on GPUs and, for tests, on the CPU.
"""

__version__ = "0.1.0"

from .core.alphabet import Alphabet, dna_alphabet, protein_alphabet
from .core.encseq import Encseq
from .core.seqio import read_seqfile, read_seqfiles
