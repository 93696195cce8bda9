"""Model zoo: every linear/contraction routes through the RMPM engine."""
from repro_torch.models.config import ArchConfig  # noqa: F401
from repro_torch.models.lm import LanguageModel, build_model  # noqa: F401
