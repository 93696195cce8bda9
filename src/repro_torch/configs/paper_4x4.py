"""The paper's own configuration: a 4x4 matrix multiplier built from 2x2
processing elements (Strassen external, RMPM multiplier internal), as the
reference's ``repro.configs.paper_4x4``."""
from repro_torch.core.policy import PAPER_BASELINE

PE_SIZE = 2        # processing element: 2x2 matmul
MATRIX_SIZE = 4    # top level: 4x4
STRASSEN_DEPTH = 1  # one level of 7-product recursion
POLICY = PAPER_BASELINE
