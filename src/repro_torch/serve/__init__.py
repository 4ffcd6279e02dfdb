# Serving: steps, session, scheduler, the gateway (graph and LM tenants)
# and its RPC front door.
