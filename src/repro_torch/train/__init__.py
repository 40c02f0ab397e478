from repro_torch.train.optimizer import (  # noqa: F401
    AdamWConfig, adamw_update, init_opt_state,
)
from repro_torch.train.serve_step import (  # noqa: F401
    greedy_generate, make_decode_step, make_prefill_step,
)
from repro_torch.train.train_step import (  # noqa: F401
    TrainState, init_train_state, make_train_step,
)
