"""ML training workloads on the PimGrid engine (port of
``repro.core.mlalgos``): the Workload API, the paper's four workloads —
linear and logistic regression, K-means and the decision tree — and
PIM-Opt's linear SVM and the multinomial generalisation of logistic
regression."""

from repro_torch.core.mlalgos import api  # noqa: F401
from repro_torch.core.mlalgos.api import (FitResult, MergeCaps,  # noqa: F401
                                          Program, Workload, fit)
from repro_torch.core.mlalgos.dtree import (DecisionTree, DTree,  # noqa: F401
                                            DTreeResult, dtree_predict,
                                            quantize_features, train_dtree)
from repro_torch.core.mlalgos.kmeans import (KMeans,  # noqa: F401
                                             KMeansResult,
                                             kmeans_assign_points,
                                             train_kmeans)
from repro_torch.core.mlalgos.linreg import (LinReg,  # noqa: F401
                                             LinRegResult, closed_form,
                                             linreg_predict,
                                             make_linreg_step, train_linreg)
from repro_torch.core.mlalgos.logreg import (LogReg,  # noqa: F401
                                             LogRegResult, accuracy,
                                             logreg_predict, train_logreg)
from repro_torch.core.mlalgos.multinomial import (  # noqa: F401
    MultinomialLogReg, MultinomialResult, multinomial_accuracy,
    multinomial_predict, train_multinomial)
from repro_torch.core.mlalgos.svm import (LinearSVM, SVMResult,  # noqa: F401
                                          svm_accuracy, svm_predict,
                                          train_svm)
