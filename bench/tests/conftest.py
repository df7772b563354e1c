import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

import torch  # noqa: E402

# The cells cut to CPU size are small: a few threads each, so that test
# workers side by side do not oversubscribe the host.
torch.set_num_threads(2)
