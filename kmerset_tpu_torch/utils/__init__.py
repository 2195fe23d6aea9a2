"""CLI helpers: flags (the reference's flag surface, --trace as a
torch.profiler trace, --device), the logger and the seeded draws."""
