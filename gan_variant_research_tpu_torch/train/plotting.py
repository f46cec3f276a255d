"""End-of-run loss plot: d_loss and g_loss curves to ``training_losses.png``
in the log dir. The port's own copy of
``gan_variant_research_tpu/train/plotting.py``; matplotlib is imported
inside the function (the loop skips the plot where it is not installed)."""

from __future__ import annotations

from pathlib import Path


def plot_training_losses(log_dir, steps, d_losses, g_losses, filename="training_losses.png"):
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(10, 5))
    ax.plot(steps, d_losses, label="d_loss", alpha=0.8)
    ax.plot(steps, g_losses, label="g_loss", alpha=0.8)
    ax.set_xlabel("step")
    ax.set_ylabel("loss")
    ax.set_title("Training losses")
    ax.legend()
    ax.grid(alpha=0.3)
    out = Path(log_dir) / filename
    out.parent.mkdir(parents=True, exist_ok=True)
    fig.savefig(out, dpi=120, bbox_inches="tight")
    plt.close(fig)
    return out
