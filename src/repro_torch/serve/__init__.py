# LM serving: steps, session, scheduler and gateway.
