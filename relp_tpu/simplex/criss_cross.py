"""Criss-cross method — placeholder.

The reference reserves an (empty) module for this future algorithm
(``src/algorithm/criss_cross/mod.rs:1-3``); mirrored here so the layout
states the same intent.  A device criss-cross would reuse this package's
pricing/ratio-test kernels without the feasibility phase split.
"""

raise_not_implemented = NotImplementedError(
    "criss-cross method not implemented (placeholder, as in the reference)"
)
