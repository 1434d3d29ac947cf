"""Device (JAX/XLA) compute ops.

All sequence data crosses the host/device boundary as packed integer arrays:

* proteins — uint8 codes (A..Z → 0..25, '*' → 26, other → 27, pad → 31)
* DNA      — uint8 codes (t,c,a,g → 0..3 NCBI order, ambiguous → 4, pad → 5)
* k-mers   — two uint32 words (5 bits/char: chars 0..5 in ``lo``, 6..11 in
  ``hi``), so exact kmer *text* identity is preserved (not just a hash);
  K ≤ 12 fits the two words, which keeps every device op in 32-bit
  integers (JAX's default width, no x64 mode needed).

Modules:

* encode      — host-side string ↔ uint8 array codecs (NumPy)
* translate   — 6-frame genetic-code translation (vectorized codon LUT)
* kmers       — k-mer window packing + ambiguity masks (Q1/Q2 drop rules)
* hashing     — 32-bit mixing of the two key words
* hashtable   — open-addressing table: device build (scatter-claim rounds)
  and device probe (gather loop)
* vote        — segmented unanimous-vote role calling (Q9)
* orf         — per-contig ORF start/stop scan arrays for Location.extend
"""
