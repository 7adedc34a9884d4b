from repro_torch.serving.engine import (Engine, EngineFns, Request,  # noqa: F401
                                        ServeConfig, SessionSnapshot,
                                        pad_tolerant)
from repro_torch.serving.kvpool import (BlockAllocator, PoolExhausted,  # noqa: F401
                                        hash_token_blocks,
                                        hash_token_blocks_memo,
                                        pack_block_arrays, padded_table,
                                        unpack_block_arrays)
