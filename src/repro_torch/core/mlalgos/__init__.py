"""ML training workloads on the PimGrid engine (port of
``repro.core.mlalgos``): the Workload API and the paper's linear and
logistic regression.  k-means, the decision tree, SVM and multinomial
regression come with their slices (ROADMAP queue A, item 8)."""

from repro_torch.core.mlalgos import api  # noqa: F401
from repro_torch.core.mlalgos.api import (FitResult, MergeCaps,  # noqa: F401
                                          Program, Workload, fit)
from repro_torch.core.mlalgos.linreg import LinReg, linreg_predict  # noqa: F401
from repro_torch.core.mlalgos.logreg import (LogReg, accuracy,  # noqa: F401
                                             logreg_predict)
