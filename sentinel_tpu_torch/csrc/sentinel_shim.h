/* sentinel_shim.h — C ABI of the sentinel-tpu native client shim.
 *
 * The language-neutral client path to the sentinel-tpu token server
 * (SURVEY.md §7 M4): JNI, JNA, ctypes, and plain C/C++ all bind these
 * symbols from libsentinel_shim.so. Wire protocol: the length-framed TLV
 * of cluster/codec.py (the reference's cluster-common Netty protocol
 * re-specified; message types PING=0, FLOW=1, PARAM_FLOW=2).
 *
 * Thread-safety: handles are multi-in-flight — N threads may issue
 * requests on ONE handle concurrently; responses are demuxed by xid
 * (the reference Netty client's xid -> promise map, shared-receiver
 * style, no background thread). Only st_client_close must not race new
 * requests on the same handle.
 */

#ifndef SENTINEL_SHIM_H_
#define SENTINEL_SHIM_H_

#ifdef __cplusplus
extern "C" {
#endif

/* TokenResultStatus values returned by the request calls (wire-visible,
 * reference core:cluster/TokenResultStatus.java):
 *   OK=0, BLOCKED=1, SHOULD_WAIT=2, NO_RULE_EXISTS=3, NO_REF_RULE_EXISTS=4,
 *   NOT_AVAILABLE=5, FAIL=-1, TOO_MANY_REQUEST=-2, BAD_REQUEST=-4.
 * -1 additionally signals local/transport failure. */

/* Connect to a token server and register `ns` via PING.
 * Returns an opaque handle, or NULL on failure. */
void* st_client_connect(const char* host, int port, const char* ns,
                        int timeout_ms);

/* Acquire `count` flow tokens for `flow_id`. Returns the status; when
 * out_extra is non-NULL it receives remaining (OK) or wait-ms
 * (SHOULD_WAIT). */
int st_request_token(void* handle, long long flow_id, int count,
                     int prioritized, int* out_extra);

/* One hot-parameter value for st_request_param_token. `tag` selects the
 * wire encoding AND which field carries the value (the server hashes
 * params typed, so an int param must be sent as an int to share buckets
 * with other clients' ints): */
typedef struct st_param {
  unsigned char tag; /* 0=int (i), 1=utf-8 string (s), 2=bool (i), 3=float (d) */
  long long i;
  double d;
  const char* s;     /* NUL-terminated; used when tag==1 */
} st_param;

/* Acquire `count` param-flow tokens for (`flow_id`, params). Returns the
 * status (PARAM_FLOW responses carry no entity). */
int st_request_param_token(void* handle, long long flow_id, int count,
                           const st_param* params, int nparams);

/* Pipelined batch acquire: all `n` FLOW requests hit the wire before any
 * response is awaited (one RTT per batch; the server micro-batches them
 * into one device step). out_statuses[i] = TokenResultStatus or -1;
 * out_extras[i] (optional) = remaining / wait-ms. Returns 0 when every
 * response arrived, -1 on transport failure. */
int st_request_tokens_batch(void* handle, const long long* flow_ids,
                            const int* counts, const int* prioritized, int n,
                            int* out_statuses, int* out_extras);

/* Remote slot-chain entry (M4 bridge, MSG_ENTRY): run the backend's full
 * rule chain + stats commit. Returns OK(0) with *out_entry_id set,
 * BLOCKED(1) with *out_reason = BlockReason code (1=flow 2=degrade
 * 3=system 4=authority 5=param 7=custom), or -1 (fail open). */
int st_remote_entry(void* handle, const char* resource, const char* origin,
                    int count, int entry_type, int prioritized,
                    const st_param* params, int nparams,
                    long long* out_entry_id, int* out_reason);

/* Remote exit (MSG_EXIT): commit RT/success, release the entry. `error`
 * non-zero records a business exception; `count` < 0 keeps the entry's
 * count. Returns OK, BAD_REQUEST (unknown id), or -1. */
int st_remote_exit(void* handle, long long entry_id, int error, int count);

void st_client_close(void* handle);

/* Cached-tick millisecond clock (reference core:util/TimeUtil.java): a
 * 1ms tick thread caches the wall clock so hot paths avoid syscalls. */
void st_time_start(void);
void st_time_stop(void);
long long st_now_ms(void);

#ifdef __cplusplus
} /* extern "C" */
#endif

#endif /* SENTINEL_SHIM_H_ */
