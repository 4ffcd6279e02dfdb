# Pattern, restriction, schedule, IEP, plan and configuration-search
# logic (numpy-only copies of the reference's modules) plus the torch
# executor.
