"""REST API plane (port of cruise_control_tpu/api/; SURVEY.md §2.7):
endpoint dispatch over the port's facade, async user tasks, two-step
verification purgatory, pluggable security."""
from cruise_control_tpu_torch.api.parameters import (VALID_PARAMS,
                                                     ParameterError,
                                                     QueryParams)
from cruise_control_tpu_torch.api.purgatory import (Purgatory, ReviewRequest,
                                                    ReviewStatus)
from cruise_control_tpu_torch.api.security import (
    AuthenticationError, AuthorizationError, BasicSecurityProvider,
    NoSecurityProvider, Principal, Role, SecurityProvider,
    TokenSecurityProvider, TrustedProxySecurityProvider)
from cruise_control_tpu_torch.api.server import BASE_PATH, CruiseControlApp
from cruise_control_tpu_torch.api.user_tasks import (USER_TASK_ID_HEADER,
                                                     TaskStatus, UserTaskInfo,
                                                     UserTaskManager)

__all__ = [
    "CruiseControlApp", "BASE_PATH", "QueryParams", "ParameterError",
    "VALID_PARAMS", "Purgatory", "ReviewRequest", "ReviewStatus",
    "SecurityProvider", "NoSecurityProvider", "BasicSecurityProvider",
    "TokenSecurityProvider", "TrustedProxySecurityProvider", "Principal",
    "Role", "AuthenticationError", "AuthorizationError",
    "UserTaskManager", "UserTaskInfo", "TaskStatus", "USER_TASK_ID_HEADER",
]
