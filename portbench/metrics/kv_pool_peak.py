"""Store (serving/store.py): the most pool blocks in use after any window
step, by the store's own census, as a share of the pool."""


def read(rec):
    used = [st.blocks_used for st in rec.steps if st.blocks_used is not None]
    if not used or not rec.pool_blocks:
        return None
    return 100.0 * max(used) / rec.pool_blocks
