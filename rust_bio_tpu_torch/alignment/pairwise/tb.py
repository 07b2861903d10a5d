"""Traceback move codes (reference: pairwise/mod.rs:1036-1046).

A traceback cell packs three 4-bit layer pointers into a uint16:
``i_bits | d_bits << 4 | s_bits << 8``; the scans put the capped vertical
insertion-run length in bits 12-15. The same codes are hard-coded in
``ops/csrc/*.cu``. Clip codes (5-8) occur only where the mode's clip
penalties are live: the semiglobal engine has the two y-clips.
``TB_REREAD`` (9) is an i-bits code of the block-row scan (K13) only: at
the first row of a row block, where the open candidate won, it stands for
the s-bits of the cell above, which the segmented walk (K14) reads.
"""

TB_START = 0
TB_INS = 1
TB_DEL = 2
TB_SUBST = 3
TB_MATCH = 4
TB_XCLIP_PREFIX = 5
TB_XCLIP_SUFFIX = 6
TB_YCLIP_PREFIX = 7
TB_YCLIP_SUFFIX = 8
TB_REREAD = 9
