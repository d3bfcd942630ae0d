// A copy of the JAX package's horovod_tpu/runtime/cpp/logging.{h,cc} under
// the port's namespace.
//
// Leveled stderr logging (reference role: horovod/common/logging.{h,cc};
// env contract kept: HOROVOD_LOG_LEVEL=trace|debug|info|warning|error|fatal,
// HOROVOD_LOG_TIMESTAMP=1).
#pragma once

#include <sstream>
#include <string>

namespace hvdtorch {

enum class LogLevel : int {
  kTrace = 0, kDebug = 1, kInfo = 2, kWarning = 3, kError = 4, kFatal = 5,
};

LogLevel MinLogLevel();
void SetMinLogLevel(LogLevel lvl);
LogLevel ParseLogLevel(const std::string& s);

class LogMessage {
 public:
  LogMessage(const char* file, int line, LogLevel level);
  ~LogMessage();
  std::ostringstream& stream() { return stream_; }

 private:
  std::ostringstream stream_;
  LogLevel level_;
};

#define HVD_LOG_IS_ON(lvl) \
  (static_cast<int>(lvl) >= static_cast<int>(::hvdtorch::MinLogLevel()))

#define HVD_LOG(lvl)                                         \
  if (HVD_LOG_IS_ON(::hvdtorch::LogLevel::lvl))                 \
  ::hvdtorch::LogMessage(__FILE__, __LINE__, ::hvdtorch::LogLevel::lvl).stream()

}  // namespace hvdtorch
