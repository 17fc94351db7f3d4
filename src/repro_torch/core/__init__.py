"""Core substrate of the port: namedarraytuple, the leading-dims protocol,
spaces, action distributions, the batch contract and the algorithm base."""
from .narrtup import (  # noqa: F401
    namedarraytuple,
    is_namedarraytuple,
    is_namedtuple,
    buffer_from_example,
    get_leading_dims,
    buffer_method,
)
from .leading_dims import infer_leading_dims, restore_leading_dims  # noqa: F401
from .spaces import Box, Discrete, Composite  # noqa: F401
from .distributions import (Categorical, Gaussian,  # noqa: F401
                            SquashedGaussian, EpsilonGreedy)
from .agent import (Agent, AgentInputs, AgentStep,  # noqa: F401
                    AlternatingAgentMixin)
from .algorithm import Algorithm, TrainState, OptInfo  # noqa: F401
from .batch_spec import (BatchSpec, make_algo_batch,  # noqa: F401
                         rollout_to_transitions, TRANSITION_FIELDS)
